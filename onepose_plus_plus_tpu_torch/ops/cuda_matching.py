"""K2: streaming dual-softmax statistics as a hand-written CUDA kernel.

Replaces ``onepose_plus_plus_tpu/ops/pallas_matching.py::dual_softmax_rowcol_stats``
(``_lse_kernel`` and ``_argmax_kernel``); ``fused_select_topk_matches`` is the
port of the function of the same name there, in ordinary tensor ops. Source:
``csrc/matching.cu`` (CUDA C++, not Triton).

The dual-softmax confidence factorises through log-sum-exps,
``log conf[p, l] = 2 s[p, l] - rowLSE[p] - colLSE[l]``, so the mutual nearest
neighbours need only row/column LSEs and two argmaxes, never the [P, L]
matrix (the dense path materialises [B, 7000, 4096] f32, 115 MB per frame,
several times). Two passes over similarity tiles: the LSE pass keeps row
statistics inside the block that owns a row tile and writes per-row-tile
column partials [B, n_row_tiles, L], merged by a second launch; the argmax
pass does the same for the argmaxes, keeping the lowest index on ties.

What bounds it on the card: FP32 FMA throughput of the two P*L*C similarity
passes, then the exponentials of the LSE pass. The design register-blocks a
64x64 tile (4x4 per thread) over 32-deep shared-memory slices and reduces the
staged tile with 4 lanes per row or column; tensor cores are later work.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels import KERNEL_DTYPES, LAUNCHES, build, check_cuda_operands, ptr, stream_ptr
from .matching import CoarseMatches, _border_keep, topk_stable
from .take import take_scalars


def _scaled(feat0, feat1, feat_norm, dtype):
    if feat_norm == "sqrt_feat_dim":
        scale = 1.0 / (feat0.shape[-1] ** 0.5)
        feat0, feat1 = feat0 * scale, feat1 * scale
    elif feat_norm not in ("none", None):
        raise ValueError(f"unknown feat_norm {feat_norm}")
    return feat0.to(dtype).contiguous(), feat1.to(dtype).contiguous()


def rowcol_stats_plain(
    f0: torch.Tensor,
    f1: torch.Tensor,
    inv_temp: float,
    row_add: Optional[torch.Tensor] = None,
    col_add: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of K2 on already-scaled operands (f32 arithmetic).

    Materialises the [B, P, L] similarity; argmaxes take the first maximum.
    """
    sim = torch.einsum("bpc,blc->bpl", f0.float(), f1.float()) * inv_temp
    if row_add is not None:
        sim = sim + row_add.float()[:, :, None]
    if col_add is not None:
        sim = sim + col_add.float()[:, None, :]
    row_lse = torch.logsumexp(sim, dim=2)
    col_lse = torch.logsumexp(sim, dim=1)
    two_s = 2.0 * sim
    row_best_val, row_best_j = torch.max(two_s - col_lse[:, None, :], dim=2)
    col_best_val, col_best_p = torch.max(two_s - row_lse[:, :, None], dim=1)
    return {
        "row_lse": row_lse,
        "col_lse": col_lse,
        "row_best_val": row_best_val,
        "row_best_j": row_best_j.to(torch.int32),
        "col_best_val": col_best_val,
        "col_best_p": col_best_p.to(torch.int32),
    }


def dual_softmax_rowcol_stats(
    feat0: torch.Tensor,
    feat1: torch.Tensor,
    temperature: float,
    row_add: Optional[torch.Tensor] = None,
    col_add: Optional[torch.Tensor] = None,
    feat_norm: str = "sqrt_feat_dim",
    dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.Tensor]:
    """Streaming dual-softmax statistics without materialising [P, L].

    Args:
        feat0: [B, P, C] row features (3D points); feat1: [B, L, C] columns.
        row_add / col_add: additive masks [B, P] / [B, L] (-1e9 at invalid).
        dtype: operand type of the similarity (float32 or bfloat16); the
            features are scaled by 1/sqrt(C) first, then cast.
    Returns dict with row_lse [B, P], col_lse [B, L], row_best_val/j [B, P],
    col_best_val/p [B, L] (int32 indices); the confidence of row p's best
    match is ``exp(row_best_val - row_lse)``. CPU tensors run the plain version.
    """
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"dual_softmax_rowcol_stats: unsupported operand dtype {dtype}")
    f0, f1 = _scaled(feat0, feat1, feat_norm, dtype)
    inv_temp = 1.0 / (temperature + 1e-4)
    radd = None if row_add is None else row_add.float().contiguous()
    cadd = None if col_add is None else col_add.float().contiguous()
    if f0.device.type == "cpu":
        return rowcol_stats_plain(f0, f1, inv_temp, radd, cadd)

    b, p, c = f0.shape
    l = f1.shape[1]
    if f1.shape != (b, l, c):
        raise ValueError(f"dual_softmax_rowcol_stats: feat1 {tuple(f1.shape)} vs feat0 {tuple(f0.shape)}")
    if radd is not None and radd.shape != (b, p):
        raise ValueError("dual_softmax_rowcol_stats: row_add must be [B, P]")
    if cadd is not None and cadd.shape != (b, l):
        raise ValueError("dual_softmax_rowcol_stats: col_add must be [B, L]")
    device = check_cuda_operands(
        "dual_softmax_rowcol_stats", f0, f1, *(t for t in (radd, cadd) if t is not None)
    )
    lib = build()
    n_pt = lib.lib.opp_rowcol_row_tiles(p)
    f32, i32 = torch.float32, torch.int32
    out = {
        "row_lse": torch.empty((b, p), dtype=f32, device=device),
        "col_lse": torch.empty((b, l), dtype=f32, device=device),
        "row_best_val": torch.empty((b, p), dtype=f32, device=device),
        "row_best_j": torch.empty((b, p), dtype=i32, device=device),
        "col_best_val": torch.empty((b, l), dtype=f32, device=device),
        "col_best_p": torch.empty((b, l), dtype=i32, device=device),
    }
    part_val = torch.empty((b, n_pt, l), dtype=f32, device=device)
    part_idx = torch.empty((b, n_pt, l), dtype=i32, device=device)
    lib.call(
        f"opp_rowcol_stats_{KERNEL_DTYPES[dtype]}",
        ptr(f0), ptr(f1), ptr(radd), ptr(cadd),
        ptr(out["row_lse"]), ptr(out["col_lse"]), ptr(out["row_best_val"]),
        ptr(out["row_best_j"]), ptr(out["col_best_val"]), ptr(out["col_best_p"]),
        ptr(part_val), ptr(part_idx), b, p, l, c, inv_temp, stream_ptr(device),
    )
    LAUNCHES["K2_rowcol_stats"] += 1
    return out


def fused_select_topk_matches(
    feat0: torch.Tensor,
    feat1: torch.Tensor,
    temperature: float,
    grid_hw: Tuple[int, int],
    thr: float,
    border_rm: int,
    k: int,
    border_two_sided: bool = False,
    row_grid_hw: Optional[Tuple[int, int]] = None,
    feat_norm: str = "sqrt_feat_dim",
    col_mask: Optional[torch.Tensor] = None,
    dtype: torch.dtype = torch.float32,
) -> CoarseMatches:
    """Streaming replacement for confidence matrix + ``select_topk_matches``.

    Border cells take part in the softmax normalisation and the mutual-NN
    argmaxes; a row whose best column lies in the removed border gives no
    match (it is not rerouted to its second-best column), like the reference
    ``mask_border`` on the thresholded mask. ``row_grid_hw`` makes the rows a
    grid too (image-pair matching), whose border rows give no match.
    """
    b, p, _ = feat0.shape
    l = feat1.shape[1]
    h, w = grid_hw
    if h * w != l:
        raise ValueError(f"grid {grid_hw} != L {l}")
    col_add = None
    if col_mask is not None:
        col_add = torch.where(col_mask.bool(), 0.0, -1e9).float()
    stats = dual_softmax_rowcol_stats(
        feat0, feat1, temperature, col_add=col_add, feat_norm=feat_norm, dtype=dtype
    )
    j_of_row = stats["row_best_j"].long()  # [B, P]
    col_keep = _border_keep(h, w, border_rm, border_two_sided, feat0.device)  # [L]
    best_p_at_j = take_scalars(stats["col_best_p"], j_of_row)
    mutual = best_p_at_j.long() == torch.arange(p, device=feat0.device)[None, :]
    keep_at_j = col_keep[j_of_row]
    conf = torch.exp(stats["row_best_val"] - stats["row_lse"])  # [B, P]
    valid = mutual & (conf > thr) & keep_at_j
    if row_grid_hw is not None:
        rh, rw = row_grid_hw
        if rh * rw != p:
            raise ValueError(f"row grid {row_grid_hw} != P {p}")
        valid = valid & _border_keep(rh, rw, border_rm, border_two_sided, feat0.device)[None, :]
    score = torch.where(valid, conf, torch.full_like(conf, -1.0))
    top_score, i_ids = topk_stable(score, k)
    j_ids = torch.gather(j_of_row, 1, i_ids)
    mask = top_score > 0.0
    mconf = torch.where(mask, top_score, torch.zeros_like(top_score))
    return CoarseMatches(i_ids.to(torch.int32), j_ids.to(torch.int32), mconf, mask)
