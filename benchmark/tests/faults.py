"""Faults planted in the program under a run, for the tests that see a run's
``correct`` come out false: each function patches the program (never the
benchmark or its reference) through pytest's ``monkeypatch``."""
from __future__ import annotations

import torch

HALF = "half of the batch left out"
ALTERED = "an answer altered where it is produced"
UNCHANGED = "a step that returns its state unchanged"
FINE_MAP = "the 1/2 map altered where it is produced"


def query(monkeypatch, fault: str) -> None:
    from onepose_plus_plus_tpu_torch.models.onepose_plus import OnePosePlusModel
    forward = OnePosePlusModel.forward

    def patched(self, *a, **k):
        out = forward(self, *a, **k)
        if fault == ALTERED:  # every match's confidence half as large again, as from a wrong temperature
            out["mconf"] = out["mconf"] * 1.5
        elif fault == HALF:  # the second half of the batch's frames left without matches
            n = out["match_mask"].shape[0]
            out["match_mask"] = torch.cat([out["match_mask"][:n // 2], torch.zeros_like(out["match_mask"][n // 2:])])
        return out

    if fault not in (ALTERED, HALF):
        raise ValueError(fault)
    monkeypatch.setattr(OnePosePlusModel, "forward", patched)


def sfm(monkeypatch, fault: str) -> None:
    from onepose_plus_plus_tpu_torch.models.loftr import LoFTRMatcher
    coarse = LoFTRMatcher.match_coarse
    if fault == ALTERED:  # the first pair's coarse matches each moved to the next cell in image 1
        def altered(self, *a):
            out = coarse(self, *a)
            out["mkpts1_c"] = out["mkpts1_c"].clone()
            out["mkpts1_c"][0, :, 0] += 8.0
            return out
        monkeypatch.setattr(LoFTRMatcher, "match_coarse", altered)
    elif fault == HALF:  # the second half of the batch's pairs left without matches
        def half(self, *a):
            out = coarse(self, *a)
            n = out["match_mask"].shape[0]
            out["match_mask"] = torch.cat([out["match_mask"][:n // 2], torch.zeros_like(out["match_mask"][n // 2:])])
            return out
        monkeypatch.setattr(LoFTRMatcher, "match_coarse", half)
    elif fault == FINE_MAP:  # the backbone's 1/2 maps a fifth larger, as from a wrong BatchNorm scale
        from onepose_plus_plus_tpu_torch.models.backbone import ResNetFPN_8_2
        backbone = ResNetFPN_8_2.forward

        def scaled(self, *a, **k):
            feat_c, feat_f = backbone(self, *a, **k)
            return feat_c, feat_f * 1.2
        monkeypatch.setattr(ResNetFPN_8_2, "forward", scaled)
    else:
        raise ValueError(fault)


def train(monkeypatch, fault: str) -> None:
    from onepose_plus_plus_tpu_torch.train import train_step as ts
    if fault == UNCHANGED:
        make = ts.make_optimizer

        def frozen(*a, **k):
            opt, sched = make(*a, **k)
            opt.step = lambda *_, **__: None
            return opt, sched
        monkeypatch.setattr(ts, "make_optimizer", frozen)
    elif fault == HALF:
        step = ts.train_step

        def half(model, optimizer, batch, *a, **k):
            n = batch["query_image"].shape[0] // 2
            return step(model, optimizer, {key: v[:n] for key, v in batch.items()}, *a, **k)
        monkeypatch.setattr(ts, "train_step", half)
    elif fault == ALTERED:
        finish = ts._finish_micro_batch

        def altered(optimizer, *a, **k):
            p = optimizer.param_groups[0]["params"][0]
            if p.grad is not None and optimizer.param_groups[0]["mini_step"] + 1 >= optimizer.param_groups[0]["grad_accum"]:
                p.grad.mul_(1.5)
            return finish(optimizer, *a, **k)
        monkeypatch.setattr(ts, "_finish_micro_batch", altered)
    else:
        raise ValueError(fault)
