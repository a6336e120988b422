"""Training losses for the 2D-3D matcher: focal coarse + std-weighted fine L2.

Port of ``onepose_plus_plus_tpu/train/losses.py`` (reference
``src/lightning_model/losses.py:7-142`` and
``src/models/OnePosePlus/utils/fine_supervision.py:4-31``). GT is sparse:
``gt_cell [N, L]`` (coarse cell of each 3D point, -1 = unmatched) and
``gt_fine_xy [N, L, 2]``; the dense semantics come back through index
comparisons, and boolean indexing becomes masked sums over the K slots.
``LossConfig`` is defined here because its JAX module loads JAX; a test holds
its fields and defaults equal to JAX's. Every normaliser is a count over the
batch; in data-parallel training (``parallel.comm.global_batch``) the sums
and counts are the global batch's (``batch_sum``), so that each rank's loss
is the global loss, as under the JAX package's sharded step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..ops.cuda_coarse_loss import fused_coarse_focal_loss
from ..parallel.comm import batch_max, batch_sum, batch_sum_samples


@dataclasses.dataclass(frozen=True)
class LossConfig:
    coarse_type: str = "focal"
    focal_alpha: float = 0.5
    focal_gamma: float = 2.0
    pos_weight: float = 1.0
    neg_weight: float = 1.0
    coarse_weight: float = 1.0
    # log-space positive focal term (default): -alpha*(1-conf)^gamma*log_conf
    # from the stable log-softmax sum, whose gradient survives confidences
    # below the reference's 1e-6 clamp; False is the reference's clamp
    log_space: bool = True
    fine_type: str = "l2_with_std"
    # base fine weight; compute_losses applies fine_weight * (window / 5)^2
    fine_weight: float = 0.25
    fine_correct_thr: float = 1.0


def effective_fine_weight(cfg: LossConfig, window_size: int) -> float:
    """Reference autoscale: ``0.25 * (W/5)^2`` (``train_onepose_plus.py:41``)."""
    return cfg.fine_weight * (window_size / 5.0) ** 2


def coarse_focal_loss(
    conf: torch.Tensor,
    gt_cell: torch.Tensor,
    cfg: LossConfig,
    c_weight: Optional[torch.Tensor] = None,
    log_conf: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Focal BCE on the dual-softmax confidence [N, L, S] against the GT cells.

    Mean of the positive terms plus mean of the negative terms, each over the
    count of its class (weights scale numerators only). ``cfg.log_space``
    computes the positive term from ``log_conf`` (capped at -1e-6), the
    clamped form is the reference's ``clamp(conf, 1e-6, 1 - 1e-6)``.
    """
    if cfg.coarse_type != "focal":
        raise ValueError(cfg.coarse_type)
    s = conf.shape[2]
    pos = gt_cell.long()[:, :, None] == torch.arange(s, device=conf.device)[None, None, :]
    alpha, gamma = cfg.focal_alpha, cfg.focal_gamma
    if cfg.log_space:
        if log_conf is None:
            # fallback only: once conf underflows to 0 this log is constant
            log_conf = torch.log(conf.clamp_min(1e-38))
        log_conf = torch.clamp(log_conf, max=-1e-6)
        conf = torch.exp(log_conf)
        loss_pos = -alpha * (1.0 - conf) ** gamma * log_conf
        loss_neg = -(1.0 - alpha) * conf ** gamma * torch.log1p(-conf)
    else:
        conf = torch.clamp(conf, 1e-6, 1.0 - 1e-6)
        loss_pos = -alpha * (1.0 - conf) ** gamma * torch.log(conf)
        loss_neg = -(1.0 - alpha) * conf ** gamma * torch.log(1.0 - conf)
    if c_weight is not None:
        loss_pos = loss_pos * c_weight
        loss_neg = loss_neg * c_weight
    local_pos = pos.sum()
    n_pos = batch_sum(local_pos)
    n_neg = batch_sum(pos.numel() - local_pos)
    pos_f = pos.to(conf.dtype)
    mean_pos = batch_sum((loss_pos * pos_f).sum()) / n_pos.clamp(min=1)
    mean_neg = batch_sum((loss_neg * (1.0 - pos_f)).sum()) / n_neg.clamp(min=1)
    return cfg.pos_weight * mean_pos + cfg.neg_weight * mean_neg


def fine_supervision(
    i_ids: torch.Tensor,
    j_ids: torch.Tensor,
    gt_cell: torch.Tensor,
    gt_fine_xy: torch.Tensor,
    hw_c: Tuple[int, int],
    coarse_scale: float,
    fine_scale: float,
    window_size: int,
    query_image_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """GT fine offsets ``expec_f_gt [N, K, 2]`` at the predicted coarse matches.

    The GT location of point i is read at the predicted (i, j); a prediction in
    the wrong coarse cell reads location 0, an out-of-window offset that the
    loss's correct mask drops.
    """
    radius = window_size // 2
    w_c = hw_c[1]
    cs = torch.tensor(coarse_scale, dtype=torch.float32, device=i_ids.device)
    fs = torch.tensor(fine_scale, dtype=torch.float32, device=i_ids.device)
    if query_image_scale is not None:
        sc = query_image_scale[:, None].flip(-1)  # (h, w) scale -> per-sample (x, y)
        cs, fs = cs * sc, fs * sc
    j = j_ids.long()
    mkpts_query = torch.stack([j % w_c, j // w_c], dim=-1).float() * cs
    i = i_ids.long()
    gt_xy = torch.gather(gt_fine_xy, 1, i[..., None].expand(-1, -1, 2))
    gt_j = torch.gather(gt_cell.long(), 1, i)
    hit = (gt_j == j) & (gt_j >= 0)
    gt_xy = torch.where(hit[..., None], gt_xy, torch.zeros_like(gt_xy))
    return (gt_xy - mkpts_query) / fs / radius


def fine_l2_std_loss(
    expec_f: torch.Tensor,
    expec_f_gt: torch.Tensor,
    slot_mask: torch.Tensor,
    cfg: LossConfig,
) -> torch.Tensor:
    """Std-weighted L2 on normalised fine offsets (reference ``losses.py:66-103``);
    the weight (inverse std over its mean across valid slots) is detached."""
    n = expec_f.shape[0]
    x = expec_f.reshape(-1, 3)
    gt = expec_f_gt.reshape(-1, 2)
    m = slot_mask.reshape(-1).bool()
    correct = (gt.abs().amax(dim=1) < cfg.fine_correct_thr) & m
    inv_std = 1.0 / x[:, 2].clamp_min(1e-10)
    # sums over the batch go sample by sample (batch_sum_samples): the same to
    # the bit in one process and over data-parallel shards
    inv_sum = batch_sum_samples(torch.where(m, inv_std, torch.zeros_like(inv_std)).reshape(n, -1).sum(1))
    mean_inv = inv_sum.detach() / batch_sum(m.sum()).clamp(min=1)
    weight = (inv_std / mean_inv.clamp_min(1e-10)).detach()
    offset_l2 = ((gt - x[:, :2]) ** 2).sum(dim=1)
    per_sample = torch.where(correct, offset_l2 * weight, torch.zeros_like(offset_l2)).reshape(n, -1).sum(1)
    return batch_sum_samples(per_sample) / batch_sum(correct.sum()).clamp(min=1)


def compute_losses(
    out: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    cfg: LossConfig,
    window_size: int,
    coarse_scale: float = 8.0,
    fine_scale: float = 2.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss and the scalars ``loss_c``, ``loss_f``, ``loss``, ``max_conf``
    from a train-mode forward and its batch (``gt_cell``, ``gt_fine_xy``,
    optional ``query_image_scale`` and ``c_weight``)."""
    if "conf_matrix" in out:
        loss_c = coarse_focal_loss(out["conf_matrix"], batch["gt_cell"], cfg,
                                   c_weight=batch.get("c_weight"), log_conf=out.get("log_conf_matrix"))
        max_conf = batch_max(out["conf_matrix"].detach().max())
    else:
        # fused route: K5 on the coarse features, never building [L, S]
        if batch.get("c_weight") is not None:
            raise ValueError("c_weight unsupported on the fused coarse loss")
        if not cfg.log_space:
            raise ValueError(
                "the fused coarse loss is log-space only (set "
                "coarse_matching.use_fused_kernel=False for clamped-reference semantics)"
            )
        ctx = out["coarse_loss_ctx"]
        f0, f1 = ctx["feats"]
        loss_c, max_conf = fused_coarse_focal_loss(
            f0, f1, batch["gt_cell"], ctx["temperature"], cfg.focal_alpha, cfg.focal_gamma,
            cfg.pos_weight, cfg.neg_weight, feat_norm=ctx["feat_norm"],
        )
    loss = loss_c * cfg.coarse_weight
    scalars = {"loss_c": loss_c}
    if "expec_f" in out:
        expec_f_gt = fine_supervision(
            out["i_ids"], out["j_ids"], batch["gt_cell"], batch["gt_fine_xy"], out["hw_c"],
            coarse_scale, fine_scale, window_size, batch.get("query_image_scale"),
        )
        loss_f = fine_l2_std_loss(out["expec_f"], expec_f_gt, out["match_mask"], cfg)
        loss = loss + loss_f * effective_fine_weight(cfg, window_size)
        scalars["loss_f"] = loss_f
    scalars["loss"] = loss
    scalars["max_conf"] = max_conf
    return loss, scalars
