"""Training the 2D-3D matcher: ``train_step`` over micro-batches of a
synthetic scene with GT correspondences, in the precision the training CLI
runs: float32, cuDNN autotuning on, TF32 as PyTorch's defaults leave it (the
CLI sets neither flag: cuDNN convolutions in TF32, matrix products in full
float32).

Set-up draws ``pool`` distinct micro-batches on the device, builds the model
and its AdamW state as the CLI does (learning rate scaled by the world batch
times ``grad_accum``), and drives that one object through its first
``check.updates`` optimizer updates through ``train_step`` itself, keeping
each micro-batch's loss, the first update's gradient (read back from Adam's
first moment) and the parameters after the last; the window then goes on
with the same object, one micro-batch a unit, cycling the pool. There is no
loader in the window.

The check: the plain reference follows the same updates from the same
weights, micro-batches and GT draws in float32 with TF32 off, and the numbers
compared are the worst relative gap of the micro-batch losses and, by the
worst leaf, of the first gradient's norm and of the parameters' change.
Leaves whose reference gradient is under a thousandth of the median leaf's
(the fine layers' query and key projections, which a length-1 source leaves
without a gradient) move by rounding alone and are left out.
"""
from __future__ import annotations

import copy
from typing import Dict, List

import numpy as np
import torch

from .. import traffic as tf
from ..reference import exact_fp32
from ..reference.model import OnePosePlus
from ..reference.train import micro_batch_loss
from ..weights import draw_state_dict


def _leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keep) -> float:
    """max over kept leaves of | |p| - |r| | / max(|r|, median |r|)."""
    norms = {k: float(ref[k].double().norm()) for k in keep}
    med = float(np.median(list(norms.values())))
    return max(abs(float(prog[k].double().norm()) - norms[k]) / max(norms[k], med) for k in keep)


class Driver:
    def __init__(self, ctx):
        self.ctx, self.tr, self.dev = ctx, ctx.traffic, ctx.device
        self.model_cfg = copy.deepcopy(ctx.config["model"])
        if ctx.control:  # the program's own bf16 path in place of float32
            self.model_cfg["compute_dtype"] = "bfloat16"

    def setup(self):
        from onepose_plus_plus_tpu_torch.models.build import onepose_config_from_dict
        from onepose_plus_plus_tpu_torch.models.onepose_plus import OnePosePlusModel
        from onepose_plus_plus_tpu_torch.train.losses import LossConfig
        from onepose_plus_plus_tpu_torch.train.train_step import TrainConfig, make_optimizer

        t, dev, tc = self.tr, self.dev, self.ctx.config["trainer"]
        torch.backends.cudnn.benchmark = True  # as the training CLI
        with torch.device("meta"):
            template = OnePosePlus(self.model_cfg).state_dict()
        self.weights = draw_state_dict(template, self.ctx.seed, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.ctx.seed)
        m, kp = self.model_cfg, self.model_cfg["keypoints_encoding"]
        self.pool = [tf.train_batch(gen, tc["batch_size"], t["img"], t["shape3d"], kp["descriptor_dim"],
                                    m["loftr_fine"]["d_model"], t["scene"]) for _ in range(t["pool"])]
        lc = self.ctx.config["loss"]
        self.cfg = TrainConfig(canonical_lr=tc["canonical_lr"], canonical_bs=tc["canonical_bs"],
                               grad_accum=tc["grad_accum"], weight_decay=tc["wd"],
                               milestones=tuple(tc["milestones"]), gamma=tc["gamma"],
                               loss=LossConfig(coarse_weight=lc["coarse_weight"], fine_weight=lc["fine_weight_base"],
                                               log_space=lc["log_space"]))
        self.lr = self.cfg.true_lr(tc["batch_size"] * tc["grad_accum"])
        self.model = OnePosePlusModel(onepose_config_from_dict(m))
        self.model.load_state_dict(self.weights)
        self.model.to(dev).train()
        self.opt, self.sched = make_optimizer(self.model, self.cfg, self.lr, t["steps_per_epoch"])
        self.gen = torch.Generator(device=dev)  # the GT slots' draws
        self.gen.manual_seed(self.ctx.seed + 1)
        self.next = 0

    def _step(self):
        from onepose_plus_plus_tpu_torch.train.train_step import train_step
        batch = self.pool[self.next % len(self.pool)]
        self.next += 1
        return train_step(self.model, self.opt, batch, self.gen, self.cfg, self.sched)

    def warm(self):
        """The first updates, through the window's own call and feed: every
        shape the window runs, and what the check compares."""
        updates, accum = self.tr["check"]["updates"], self.cfg.grad_accum
        self.losses: List[float] = []
        names = [n for n, _ in self.model.named_parameters()]
        for u in range(updates):
            for _ in range(accum):
                self.losses.append(float(self._step()["loss"]))
            if u == 0:  # Adam's first moment after one update is (1 - b1) g
                b1 = self.opt.param_groups[0]["betas"][0]
                self.grad1 = {n: self.opt.state[p]["exp_avg"].detach() / (1 - b1) if "exp_avg" in self.opt.state[p]
                              else torch.zeros_like(p) for n, p in zip(names, self.model.parameters())}
        self.params = {n: p.detach().clone() for n, p in self.model.named_parameters()}

    def unit(self) -> Dict[str, float]:
        self._step()
        return {"frames": self.ctx.config["trainer"]["batch_size"], "units": 1}

    def drain(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def shapes(self) -> Dict:
        t = self.tr
        return {"model": self.model_cfg, "img": t["img"], "n_points": t["shape3d"],
                "batch": self.ctx.config["trainer"]["batch_size"],
                "slots": self.model_cfg["match_coarse"]["train_max_matches"],
                "precision": "tf32" if torch.backends.cudnn.allow_tf32 else "f32"}

    def release(self):
        del self.model, self.opt, self.sched

    # ------------------------------------------------------------- check
    def check(self) -> Dict[str, float]:
        tc, lc = self.ctx.config["trainer"], self.ctx.config["loss"]
        ref = OnePosePlus(self.model_cfg).to(self.dev).train()
        ref.load_state_dict(self.weights)
        opt = torch.optim.AdamW(ref.parameters(), lr=self.lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=tc["wd"])
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(self.ctx.seed + 1)
        losses, grad1, accum = [], None, tc["grad_accum"]
        with exact_fp32():
            for u in range(self.tr["check"]["updates"]):
                opt.zero_grad(set_to_none=True)
                for k in range(accum):
                    loss, sc = micro_batch_loss(ref, self.pool[u * accum + k], gen, lc)
                    (loss / accum).backward()
                    losses.append(sc["loss"])
                if u == 0:
                    grad1 = {n: p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p)
                             for n, p in ref.named_parameters()}
                opt.step()
        params = {n: p.detach() for n, p in ref.named_parameters()}
        norms = {n: float(g.double().norm()) for n, g in grad1.items()}
        med = float(np.median(list(norms.values())))
        keep = [n for n in norms if norms[n] >= 1e-3 * med]
        start = {n: self.weights[n] for n in params}
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(self.losses, losses))
        delta_p = {n: self.params[n] - start[n] for n in keep}
        delta_r = {n: params[n] - start[n] for n in keep}
        fine = [n for n in keep if n.startswith("loftr_fine")]
        return {
            "loss_gap": loss_gap,
            "grad_gap": _leaf_gap(self.grad1, grad1, keep),
            "update_gap": _leaf_gap(delta_p, delta_r, keep),
            # the fine transformer's first gradients, by the median leaf's relative distance (PERF.md §6)
            "fine_grad_gap": float(np.median([float((self.grad1[n] - grad1[n]).double().norm()
                                                    / grad1[n].double().norm()) for n in fine])),
        }
