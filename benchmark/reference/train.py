"""Plain PyTorch reference of a training micro-batch of the 2D-3D matcher:
the GT slots appended to the predicted ones, the coarse focal loss on the
dense dual-softmax (its positive term in log space) and the std-weighted L2
loss of the fine offsets, as the published OnePose++ losses
(``src/lightning_model/losses.py``, ``fine_supervision.py``) with the
log-space positive term the port trains with.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def gt_rows(gt_cell: torch.Tensor, num: int, generator: torch.Generator) -> torch.Tensor:
    """[N, num] rows for the GT slots: a draw without replacement among the
    rows that have a GT cell (Gumbel keys from one uniform draw a micro-batch,
    lower row first among equal keys)."""
    u = torch.rand(gt_cell.shape, generator=generator, device=gt_cell.device)
    g = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    keys = torch.where(gt_cell >= 0, g, torch.full_like(g, float("-inf")))
    return torch.sort(keys, dim=1, descending=True, stable=True)[1][:, :num]


def gt_slots(gt_cell: torch.Tensor, rows: torch.Tensor):
    """(i_ids, j_ids, mask) of the GT slots: slot t takes drawn row
    min(t, n_gt - 1); a frame without GT gives masked slots."""
    n, num = rows.shape
    n_gt = (gt_cell >= 0).sum(1, keepdim=True)
    t = torch.arange(num, device=gt_cell.device)[None]
    i = torch.gather(rows, 1, torch.where(n_gt > 0, torch.minimum(t, n_gt - 1), torch.zeros_like(t)))
    j = torch.gather(gt_cell.long().clamp_min(0), 1, i)
    return i, j, (n_gt > 0).expand(n, num)


def coarse_loss(log_conf: torch.Tensor, gt_cell: torch.Tensor, alpha: float, gamma: float) -> torch.Tensor:
    """Focal loss: mean of the positive terms over the positives plus mean of
    the negative terms over the negatives."""
    s = log_conf.shape[2]
    pos = gt_cell.long()[:, :, None] == torch.arange(s, device=log_conf.device)[None, None]
    lc = log_conf.clamp(max=-1e-6)
    conf = torch.exp(lc)
    loss_pos = -alpha * (1 - conf) ** gamma * lc
    loss_neg = -(1 - alpha) * conf ** gamma * torch.log1p(-conf)
    n_pos = pos.sum()
    return (torch.where(pos, loss_pos, 0.0).sum() / n_pos.clamp(min=1)
            + torch.where(pos, 0.0, loss_neg).sum() / (pos.numel() - n_pos).clamp(min=1))


def fine_loss(out: Dict, gt_cell: torch.Tensor, gt_fine_xy: torch.Tensor, window: int,
              coarse_scale: float = 8.0, fine_scale: float = 2.0, correct_thr: float = 1.0) -> torch.Tensor:
    """Std-weighted L2 between the predicted fine offsets and the GT ones, over
    the slots whose GT offset lies inside the window."""
    w_c = out["hw_c"][1]
    j, i = out["j_ids"].long(), out["i_ids"].long()
    mk_c = torch.stack([j % w_c, j // w_c], -1).float() * coarse_scale
    gt_xy = torch.gather(gt_fine_xy, 1, i[..., None].expand(-1, -1, 2))
    gt_j = torch.gather(gt_cell.long(), 1, i)
    gt_xy = torch.where(((gt_j == j) & (gt_j >= 0))[..., None], gt_xy, torch.zeros_like(gt_xy))
    gt = ((gt_xy - mk_c) / fine_scale / (window // 2)).reshape(-1, 2)
    x = out["expec_f"].reshape(-1, 3)
    m = out["mask"].reshape(-1)
    correct = (gt.abs().amax(1) < correct_thr) & m
    inv_std = 1.0 / x[:, 2].clamp_min(1e-10)
    mean_inv = (torch.where(m, inv_std, 0.0).sum() / m.sum().clamp(min=1)).detach()
    weight = (inv_std / mean_inv.clamp_min(1e-10)).detach()
    l2 = ((gt - x[:, :2]) ** 2).sum(1)
    return torch.where(correct, l2 * weight, 0.0).sum() / correct.sum().clamp(min=1)


def micro_batch_loss(model, batch: Dict[str, torch.Tensor], generator: torch.Generator,
                     loss_cfg: Dict) -> Tuple[torch.Tensor, Dict[str, float]]:
    """The train-mode forward and the total loss of one micro-batch."""
    cm = model.cm
    rows = gt_rows(batch["gt_cell"], cm["train_pad_num_gt_min"], generator)
    out = model(batch["query_image"], batch["keypoints3d"], batch["descriptors3d"],
                batch["descriptors3d_coarse"], train=True, gt_slots=gt_slots(batch["gt_cell"], rows))
    loss_c = coarse_loss(out["log_conf"], batch["gt_cell"], loss_cfg["focal_alpha"], loss_cfg["focal_gamma"])
    loss_f = fine_loss(out, batch["gt_cell"], batch["gt_fine_xy"], model.window)
    loss = loss_c * loss_cfg["coarse_weight"] + loss_f * loss_cfg["fine_weight_base"] * (model.window / 5.0) ** 2
    return loss, {"loss_c": loss_c.item(), "loss_f": loss_f.item(), "loss": loss.item()}
