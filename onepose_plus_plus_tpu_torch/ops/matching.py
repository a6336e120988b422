"""Dual-softmax coarse matching into K fixed match slots (dense path).

Port of ``onepose_plus_plus_tpu/ops/matching.py`` (reference
``src/models/OnePosePlus/utils/coarse_matching.py:56-251``). Matches live in K
static slots with a validity mask; under mutual nearest neighbours each row
has at most one column, so row-wise top-K selection loses nothing while
K >= #matches. This path materialises the [N, L, S] confidence; the main path
selects with the streaming K2 kernel (``ops/cuda_matching.py``). Training
appends GT slots (:func:`pad_matches_with_gt`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..parallel.comm import batch_shard


class CoarseMatches(NamedTuple):
    """K fixed match slots per batch element."""

    i_ids: torch.Tensor  # [N, K] int32 row index (3D point id)
    j_ids: torch.Tensor  # [N, K] int32 column index (query grid cell)
    mconf: torch.Tensor  # [N, K] confidence (0 for invalid slots)
    mask: torch.Tensor  # [N, K] bool validity


def dual_softmax_confidence(
    feat0: torch.Tensor,
    feat1: torch.Tensor,
    temperature: float,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
    feat_norm: str = "sqrt_feat_dim",
) -> torch.Tensor:
    """Dual-softmax confidence [N, L, S] from features [N, L, C], [N, S, C] (f32)."""
    feat0, feat1 = feat0.float(), feat1.float()
    if feat_norm == "sqrt_feat_dim":
        scale = 1.0 / (feat0.shape[-1] ** 0.5)
        feat0, feat1 = feat0 * scale, feat1 * scale
    elif feat_norm not in ("none", None):
        raise ValueError(f"unknown feat_norm {feat_norm}")
    sim = torch.einsum("nlc,nsc->nls", feat0, feat1) / (temperature + 1e-4)
    if mask0 is not None or mask1 is not None:
        n, l, s = sim.shape
        m0 = mask0.bool() if mask0 is not None else torch.ones((n, l), dtype=torch.bool, device=sim.device)
        m1 = mask1.bool() if mask1 is not None else torch.ones((n, s), dtype=torch.bool, device=sim.device)
        valid = m0[:, :, None] & m1[:, None, :]
        sim = sim + torch.where(valid, 0.0, -1e9)
    return torch.softmax(sim, dim=1) * torch.softmax(sim, dim=2)


def dual_softmax_log_confidence(
    feat0: torch.Tensor,
    feat1: torch.Tensor,
    temperature: float,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
    feat_norm: str = "sqrt_feat_dim",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(conf, log_conf) with ``log_conf = log_softmax(sim, 1) + log_softmax(sim, 2)``.

    The log form stays finite, with bounded gradients, where the product of the
    two softmaxes underflows f32; the log-space coarse focal loss consumes it.
    """
    feat0, feat1 = feat0.float(), feat1.float()
    if feat_norm == "sqrt_feat_dim":
        scale = 1.0 / (feat0.shape[-1] ** 0.5)
        feat0, feat1 = feat0 * scale, feat1 * scale
    elif feat_norm not in ("none", None):
        raise ValueError(f"unknown feat_norm {feat_norm}")
    sim = torch.einsum("nlc,nsc->nls", feat0, feat1) / (temperature + 1e-4)
    if mask0 is not None or mask1 is not None:
        n, l, s = sim.shape
        m0 = mask0.bool() if mask0 is not None else torch.ones((n, l), dtype=torch.bool, device=sim.device)
        m1 = mask1.bool() if mask1 is not None else torch.ones((n, s), dtype=torch.bool, device=sim.device)
        sim = sim + torch.where(m0[:, :, None] & m1[:, None, :], 0.0, -1e9)
    log_conf = torch.log_softmax(sim, dim=1) + torch.log_softmax(sim, dim=2)
    return torch.exp(log_conf), log_conf


def _border_keep(h: int, w: int, border: int, two_sided: bool, device=None) -> torch.Tensor:
    """[h*w] bool: grid cells outside the removed border.

    ``two_sided=False`` keeps the reference 2D-3D matcher quirk: the torch
    slice ``m[..., -b:0]`` is empty, so only the top/left borders are removed.
    """
    idx = torch.arange(h * w, device=device)
    r, c = idx // w, idx % w
    keep = (r >= border) & (c >= border)
    if two_sided:
        keep = keep & (r < h - border) & (c < w - border)
    return keep


def border_keep_padded(mask: torch.Tensor, grid_hw: Tuple[int, int], border: int) -> torch.Tensor:
    """[N, h*w] bool: cells of each padded grid outside the removed border,
    measured from the valid extent of its mask [N, h*w] (True where the cell
    holds image): LoFTR's ``mask_border_with_padding``, the border of
    ``border`` cells removed on all four sides of each image's own extent, so
    that the padding beyond it is removed too. ``border`` 0 removes nothing,
    as there."""
    n = mask.shape[0]
    h, w = grid_hw
    if border <= 0:
        return torch.ones((n, h * w), dtype=torch.bool, device=mask.device)
    m = mask.reshape(n, h, w).bool()
    rows = m.sum(1).amax(-1)  # [N] valid rows (the longest column of valid cells)
    cols = m.sum(2).amax(-1)  # [N] valid columns
    idx = torch.arange(h * w, device=mask.device)
    r, c = (idx // w)[None], (idx % w)[None]
    return ((r >= border) & (c >= border) & (r < (rows - border)[:, None]) & (c < (cols - border)[:, None]))


def topk_stable(score: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, lower index first among equal scores (as
    ``lax.top_k``); pads to k slots with score -1 and index 0 when k > L."""
    n, l = score.shape
    k_eff = min(k, l)
    top_score, idx = torch.sort(score, dim=1, descending=True, stable=True)
    top_score, idx = top_score[:, :k_eff], idx[:, :k_eff]
    if k_eff < k:
        top_score = torch.cat([top_score, top_score.new_full((n, k - k_eff), -1.0)], dim=1)
        idx = torch.cat([idx, idx.new_zeros((n, k - k_eff))], dim=1)
    return top_score, idx


def select_topk_matches(
    conf: torch.Tensor,
    grid_hw: Tuple[int, int],
    thr: float,
    border_rm: int,
    k: int,
    border_two_sided: bool = False,
    row_grid_hw: Optional[Tuple[int, int]] = None,
    row_mask: Optional[torch.Tensor] = None,
    col_mask: Optional[torch.Tensor] = None,
) -> CoarseMatches:
    """Mutual-nearest-neighbour + threshold + border filter into K slots.

    Args:
        conf: [N, L, S] dual-softmax confidence.
        grid_hw: (h, w) of the S-axis grid (query image coarse grid).
        row_grid_hw: if given, the L axis is also an (h, w) grid whose border
            is removed too (image-pair matching); otherwise L indexes 3D points.
        row_mask, col_mask: [N, L], [N, S] padding masks of an image pair
            padded bottom-right (``conf`` computed with them): the border is
            then removed per pair from each image's valid extent
            (:func:`border_keep_padded`), both given or neither.
    """
    n, l, s = conf.shape
    h, w = grid_hw
    if h * w != s:
        raise ValueError(f"grid {grid_hw} != S {s}")
    row_max = conf.amax(dim=2, keepdim=True)
    col_max = conf.amax(dim=1, keepdim=True)
    valid = (conf == row_max) & (conf == col_max) & (conf > thr)
    if row_mask is not None:
        if row_grid_hw is None or col_mask is None:
            raise ValueError("padding masks need row_grid_hw and both masks")
        valid = valid & border_keep_padded(col_mask, grid_hw, border_rm)[:, None, :]
        valid = valid & border_keep_padded(row_mask, row_grid_hw, border_rm)[:, :, None]
    else:
        valid = valid & _border_keep(h, w, border_rm, border_two_sided, conf.device)[None, None, :]
        if row_grid_hw is not None:
            rh, rw = row_grid_hw
            if rh * rw != l:
                raise ValueError(f"row grid {row_grid_hw} != L {l}")
            valid = valid & _border_keep(rh, rw, border_rm, border_two_sided, conf.device)[None, :, None]
    row_has = valid.any(dim=2)
    j_of_row = torch.argmax(torch.where(valid, conf, torch.full_like(conf, -1.0)), dim=2)
    conf_of_row = torch.gather(conf, 2, j_of_row[:, :, None])[..., 0]
    score = torch.where(row_has, conf_of_row, torch.full_like(conf_of_row, -1.0))
    top_score, i_ids = topk_stable(score, k)
    j_ids = torch.gather(j_of_row, 1, i_ids)
    mask = top_score > 0.0
    mconf = torch.where(mask, top_score, torch.zeros_like(top_score))
    return CoarseMatches(i_ids.to(torch.int32), j_ids.to(torch.int32), mconf, mask)


def sample_gt_rows(gt_cell: torch.Tensor, num: int, generator: torch.Generator) -> torch.Tensor:
    """Rows for the GT slots: Gumbel top-``num`` over the rows with a GT cell
    (sampling without replacement), [N, num]. Rows without GT get -inf and come
    last; the assembly wraps around when there are fewer GT rows than slots.

    In data-parallel training each sample's draw depends on its index in the
    global batch: every rank draws the global batch's uniforms from the same
    generator and keeps its own shard's rows, which is what one process
    draws on the concatenated batch."""
    shard, shards = batch_shard()
    n = gt_cell.shape[0]
    u = torch.rand((shards * n, *gt_cell.shape[1:]), generator=generator,
                   device=gt_cell.device)[shard * n:(shard + 1) * n]
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    scores = torch.where(gt_cell >= 0, gumbel, torch.full_like(gumbel, float("-inf")))
    return topk_stable(scores, num)[1]


def pad_matches_with_gt(
    matches: CoarseMatches,
    gt_cell: torch.Tensor,
    num_gt_min: int,
    generator: Optional[torch.Generator] = None,
    rows: Optional[torch.Tensor] = None,
) -> CoarseMatches:
    """Training-time GT padding: append ``num_gt_min`` GT slots to the K
    prediction slots (K + num_gt_min slots out).

    GT slots carry mconf 0 and mask True (False for a frame without GT).
    ``rows`` [N, num_gt_min] are the sampled rows in sampling order; when
    absent they are drawn from ``generator`` by :func:`sample_gt_rows`
    (a test injects the JAX package's rows here). Slot t takes sampled row
    min(t, n_gt - 1), so a frame with fewer GT rows than slots repeats its
    last one.
    """
    n = gt_cell.shape[0]
    if rows is None:
        rows = sample_gt_rows(gt_cell, num_gt_min, generator)
    rows = rows.long()
    n_gt = (gt_cell >= 0).sum(dim=1, keepdim=True)  # [N, 1]
    slot = torch.arange(num_gt_min, device=gt_cell.device)[None, :]
    take = torch.where(n_gt > 0, torch.minimum(slot, n_gt - 1), torch.zeros_like(slot))
    gt_i = torch.gather(rows, 1, take)
    gt_j = torch.gather(gt_cell.long().clamp_min(0), 1, gt_i)
    gt_mask = (n_gt > 0).expand(n, num_gt_min)
    return CoarseMatches(
        torch.cat([matches.i_ids, gt_i.to(torch.int32)], dim=1),
        torch.cat([matches.j_ids, gt_j.to(torch.int32)], dim=1),
        torch.cat([matches.mconf, matches.mconf.new_zeros((n, num_gt_min))], dim=1),
        torch.cat([matches.mask, gt_mask], dim=1),
    )
