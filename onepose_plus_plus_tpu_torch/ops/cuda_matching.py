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

What bounds it on the card: the two P*L*C similarity products on the tensor
cores, then the 2 P L exponentials of the LSE pass on the special-function
units. Four instances, all on the tensor cores (:func:`k2_instance`):

- **bfloat16 operands** (the bench, inference and SfM configurations): the
  tensor cores, through ``wgmma`` (``csrc/sim_tile_tc.cuh``). The wrapper
  packs each operand once (:func:`pack_operand`, one launch each): scaled,
  rounded to bf16, channels zero-padded to a multiple of 16 and rows to a
  multiple of 64, in the unswizzled K-major core-matrix layout, so that a
  64-row tile is one bulk copy. One warpgroup a block keeps its f0 tile in
  shared memory, streams the f1 tiles through a two-stage ring, and reduces
  the accumulator fragments in registers (rows across a quad, columns across
  the warp's quads and then the four warps), with branch-free ``ex2.approx``
  exponentials. C up to 576 (three tiles fill a block's shared memory).
- **float32 operands up to C = 576** (the demo and the train config): the
  same passes on the tensor cores in split TF32 (``csrc/sim_tile_tf32.cuh``):
  each product as three TF32 products of hi/lo halves (``x_lo y_hi + x_hi y_lo
  + x_hi y_hi``, ~2^-22 relative), so the f32 tolerances hold. The wrapper
  packs each operand once (:func:`pack_tf32_operand`): scaled f32 in
  32-channel chunks of 64-row tiles; the kernel keeps the f0 tile f32 and
  splits its A fragments in registers, splits each streamed f1 chunk into
  hi and lo images in shared memory, and sums each pair of chunks in a fresh
  accumulator that is added into an f32 register sum (within twice plain
  f32's distance to a float64 LSE).
- **above 576 channels, at any width** (``"wide_bf16"``, ``"wide_tf32"``):
  ``csrc/sim_tile_wide.cuh``, the channel-streaming product loops of
  ``csrc/wgmma_gemm.cuh``. No tile stays resident: a block owns a 64-row f0
  tile and streams 64-channel chunks of it and of a 128-row f1 tile (128
  columns of s) from L2 by bulk copies, the ring running on from one column
  tile into the next; the same passes and epilogues as the other instances,
  over 128 columns. bf16 operands (:func:`pack_wide_operand`: f0 in 64-row,
  f1 in 128-row tiles, each [tile][64-channel chunk] image contiguous) at the
  JAX kernel's precision, the whole k summed on the tensor cores; f32
  operands in split TF32, f0 as the split-TF32 pack at 64-channel padding and
  f1 as TF32 hi and lo images (:func:`pack_tf32_hilo`), each pair of chunks
  summed in a fresh accumulator and then in f32.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels import KERNEL_DTYPES, LAUNCHES, build, check_cuda_operands, ptr, stream_ptr, tf32_split
from .matching import CoarseMatches, _border_keep, topk_stable
from .take import take_scalars


TC_MAX_CHANNELS = 576  # the resident-tile instances' widest operand (csrc/sim_tile_tc.cuh, sim_tile_tf32.cuh)
PACK_ROWS = 64  # packed rows are a multiple of a block's rows (csrc/sim_tile_tc.cuh: TM)
TF32_CHUNK = 32  # channels of a streamed chunk of the split-TF32 instance (csrc/sim_tile_tf32.cuh: KC)
WIDE_CHANNELS = 64  # the wide instances' channel padding and bf16 chunk (csrc/sim_tile_wide.cuh: KP)
WIDE_COLS = 128  # rows of the wide instances' f1 tiles: columns of s a product gives (sim_tile_wide.cuh: NC)


def k2_instance(c: int, dtype: torch.dtype) -> str:
    """The instance K2 runs at C channels with operands of ``dtype`` on the
    card: ``"tc"`` (bf16) and ``"tf32x3"`` (f32 in split TF32) up to 576
    channels, ``"wide_bf16"`` and ``"wide_tf32"`` above, at any width."""
    if c <= 0:
        raise ValueError(f"dual_softmax_rowcol_stats: C={c}")
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"dual_softmax_rowcol_stats: unsupported operand dtype {dtype}")
    bf16 = dtype == torch.bfloat16
    if c <= TC_MAX_CHANNELS:
        return "tc" if bf16 else "tf32x3"
    return "wide_bf16" if bf16 else "wide_tf32"


def _scale(feat: torch.Tensor, feat_norm: str) -> float:
    if feat_norm == "sqrt_feat_dim":
        return 1.0 / (feat.shape[-1] ** 0.5)
    if feat_norm not in ("none", None):
        raise ValueError(f"unknown feat_norm {feat_norm}")
    return 1.0


def _scaled(feat0, feat1, feat_norm, dtype):
    scale = _scale(feat0, feat_norm)
    if scale != 1.0:
        feat0, feat1 = feat0 * scale, feat1 * scale
    return feat0.to(dtype).contiguous(), feat1.to(dtype).contiguous()


def packed_shape(b: int, rows: int, c: int) -> Tuple[int, int, int, int, int]:
    """[B, rows_pad / 8, Cp / 8, 8, 8]: rows padded to a multiple of 64, C to 16."""
    rows_pad = -(-rows // PACK_ROWS) * PACK_ROWS
    cp = -(-c // 16) * 16
    return (b, rows_pad // 8, cp // 8, 8, 8)


def pack_operand_plain(feat: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of the operand pack: ``(feat * scale).to(bfloat16)``
    with zero rows and channels appended, as [B, rows_pad / 8, Cp / 8, 8, 8]
    (:func:`packed_shape`), so that element (r, k) of a batch element lies at
    byte ``(r // 8) * 16 Cp + (k // 8) * 128 + (r % 8) * 16 + (k % 8) * 2``, the
    unswizzled K-major layout ``csrc/wgmma.cuh`` describes."""
    b, rows, c = feat.shape
    shape = packed_shape(b, rows, c)
    x = (feat * scale if scale != 1.0 else feat).to(torch.bfloat16)
    out = x.new_zeros(b, shape[1] * 8, shape[2] * 8)
    out[:, :rows, :c] = x
    return out.view(b, shape[1], 8, shape[2], 8).permute(0, 1, 3, 2, 4).contiguous()


def pack_operand(feat: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """The operand layout of the tensor-core instances of K2 and K5 (see
    :func:`pack_operand_plain`); on a CUDA tensor one launch of the pack kernel
    (float32 or bfloat16 input). CPU tensors run the plain version."""
    if feat.device.type == "cpu":
        return pack_operand_plain(feat, scale)
    if feat.dtype not in KERNEL_DTYPES:
        feat = feat.float()
    feat = feat.contiguous()
    b, rows, c = feat.shape
    if c > TC_MAX_CHANNELS:
        raise ValueError(f"pack_operand: C={c} > {TC_MAX_CHANNELS}")
    device = check_cuda_operands("pack_operand", feat)
    out = torch.empty(packed_shape(b, rows, c), dtype=torch.bfloat16, device=device)
    build().call(f"opp_pack_operand_{KERNEL_DTYPES[feat.dtype]}", ptr(feat), ptr(out), b, rows, c,
                 scale, stream_ptr(device))
    return out


def tf32_packed_shape(b: int, rows: int, c: int, pad: int = TF32_CHUNK) -> Tuple[int, ...]:
    """[B, rows_pad / 64, Cp / 32, 8, 8, 8, 4]: rows padded to a multiple of 64,
    C to ``pad`` (32; 64 for the wide instance's f0)."""
    rows_pad = -(-rows // PACK_ROWS) * PACK_ROWS
    cp = -(-c // pad) * pad
    return (b, rows_pad // PACK_ROWS, cp // TF32_CHUNK, 8, 8, 8, 4)


def pack_tf32_operand_plain(feat: torch.Tensor, scale: float = 1.0, pad: int = TF32_CHUNK) -> torch.Tensor:
    """Plain PyTorch version of the split-TF32 instance's operand pack:
    ``feat.float() * scale`` with zero rows and channels appended, as
    [B, rows_pad / 64, Cp / 32, 8, 8, 8, 4] (:func:`tf32_packed_shape`), so that
    element (r, k) of a 64-row tile lies at byte ``(k // 32) * 8192 +
    ((r % 64) // 8) * 1024 + ((k % 32) // 4) * 128 + (r % 8) * 16 + (k % 4) * 4``:
    each 32-channel chunk the unswizzled K-major layout ``csrc/wgmma.cuh``
    describes for 4-byte values, contiguous (``gemm::in_chunk32``)."""
    b, rows, c = feat.shape
    shape = tf32_packed_shape(b, rows, c, pad)
    x = feat.float() * scale if scale != 1.0 else feat.float()
    out = x.new_zeros(b, shape[1] * PACK_ROWS, shape[2] * TF32_CHUNK)
    out[:, :rows, :c] = x
    # [b, tile, rg, r8, chunk, kq, kc] -> [b, tile, chunk, rg, kq, r8, kc]
    t = out.view(b, shape[1], 8, 8, shape[2], 8, 4)
    return t.permute(0, 1, 4, 2, 5, 3, 6).contiguous()


def pack_tf32_operand(feat: torch.Tensor, scale: float = 1.0, pad: int = TF32_CHUNK) -> torch.Tensor:
    """The operand layout of K2's split-TF32 instance and of the wide one's f0
    (``pad`` = 64; see :func:`pack_tf32_operand_plain`); on a CUDA float32
    tensor one launch of the pack kernel. CPU tensors run the plain version."""
    if feat.device.type == "cpu":
        return pack_tf32_operand_plain(feat, scale, pad)
    if feat.dtype != torch.float32:
        raise ValueError(f"pack_tf32_operand: float32 features only, got {feat.dtype}")
    feat = feat.contiguous()
    shape = tf32_packed_shape(*feat.shape, pad)
    device = check_cuda_operands("pack_tf32_operand", feat)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    b, rows, c = feat.shape
    build().call("opp_pack_tf32_operand_f32", ptr(feat), ptr(out), b, rows, c, shape[2] * TF32_CHUNK, scale,
                 stream_ptr(device))
    return out


def wide_packed_shape(b: int, rows: int, c: int, tile_rows: int) -> Tuple[int, ...]:
    """[B, rows_pad / TR, Cp / 64, TR / 8, 8, 8, 8]: rows padded to a multiple of
    ``tile_rows`` (TR: 64 for f0, 128 for f1), C to 64."""
    rows_pad = -(-rows // tile_rows) * tile_rows
    cp = -(-c // WIDE_CHANNELS) * WIDE_CHANNELS
    return (b, rows_pad // tile_rows, cp // WIDE_CHANNELS, tile_rows // 8, 8, 8, 8)


def pack_wide_operand_plain(feat: torch.Tensor, scale: float, tile_rows: int) -> torch.Tensor:
    """Plain PyTorch version of the wide bf16 instance's operand pack:
    ``(feat * scale).to(bfloat16)`` with zero rows and channels appended, as
    [B, rows_pad / TR, Cp / 64, TR / 8, 8, 8, 8] (:func:`wide_packed_shape`), so
    that element (r, k) lies at byte ``(r // TR) * 2 TR Cp + (k // 64) * 128 TR
    + in_chunk(r % TR, k % 64)`` with ``in_chunk(r, k) = (r // 8) * 1024 +
    (k // 8) * 128 + (r % 8) * 16 + (k % 8) * 2`` (``csrc/wgmma_gemm.cuh``):
    each [tile][64-channel chunk] image one contiguous bulk copy."""
    b, rows, c = feat.shape
    shape = wide_packed_shape(b, rows, c, tile_rows)
    x = (feat * scale if scale != 1.0 else feat).to(torch.bfloat16)
    out = x.new_zeros(b, shape[1] * tile_rows, shape[2] * WIDE_CHANNELS)
    out[:, :rows, :c] = x
    # [b, tile, rg, r8, chunk, kg, k8] -> [b, tile, chunk, rg, kg, r8, k8]
    t = out.view(b, shape[1], shape[3], 8, shape[2], 8, 8)
    return t.permute(0, 1, 4, 2, 5, 3, 6).contiguous()


def pack_wide_operand(feat: torch.Tensor, scale: float, tile_rows: int) -> torch.Tensor:
    """The wide bf16 instance's operand layout (see :func:`pack_wide_operand_plain`);
    on a CUDA tensor one launch of the pack kernel (float32 or bfloat16 input).
    CPU tensors run the plain version."""
    if feat.device.type == "cpu":
        return pack_wide_operand_plain(feat, scale, tile_rows)
    if tile_rows not in (PACK_ROWS, WIDE_COLS):
        raise ValueError(f"pack_wide_operand: tile_rows={tile_rows}, not {PACK_ROWS} or {WIDE_COLS}")
    if feat.dtype not in KERNEL_DTYPES:
        feat = feat.float()
    feat = feat.contiguous()
    b, rows, c = feat.shape
    device = check_cuda_operands("pack_wide_operand", feat)
    out = torch.empty(wide_packed_shape(b, rows, c, tile_rows), dtype=torch.bfloat16, device=device)
    build().call(f"opp_pack_wide_{KERNEL_DTYPES[feat.dtype]}", ptr(feat), ptr(out), b, rows, c, tile_rows,
                 scale, stream_ptr(device))
    return out


def tf32_hilo_packed_shape(b: int, rows: int, c: int) -> Tuple[int, ...]:
    """[B, rows_pad / 128, Cp / 32, 2, 16, 8, 8, 4]: rows padded to 128, C to 64."""
    rows_pad = -(-rows // WIDE_COLS) * WIDE_COLS
    cp = -(-c // WIDE_CHANNELS) * WIDE_CHANNELS
    return (b, rows_pad // WIDE_COLS, cp // TF32_CHUNK, 2, WIDE_COLS // 8, 8, 8, 4)


def pack_tf32_hilo_plain(feat: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of the wide split-TF32 instance's f1 pack: the
    halves ``hi, lo = kernels.tf32_split(feat.float() * scale)`` with zero rows
    and channels appended, as [B, rows_pad / 128, Cp / 32, 2, 16, 8, 8, 4]
    (:func:`tf32_hilo_packed_shape`): for each 128-row tile and 32-channel
    chunk the hi image, then the lo image, element (r, k) of each at byte
    ``in_chunk32(r % 128, k % 32) = (r // 8) * 1024 + (k // 4) * 128 + (r % 8)
    * 16 + (k % 4) * 4`` (``csrc/wgmma_gemm.cuh``), as ``run_tf32``'s B operand."""
    b, rows, c = feat.shape
    shape = tf32_hilo_packed_shape(b, rows, c)
    x = feat.float() * scale if scale != 1.0 else feat.float()
    out = x.new_zeros(b, shape[1] * WIDE_COLS, shape[2] * TF32_CHUNK)
    out[:, :rows, :c] = x
    halves = torch.stack(tf32_split(out), 1)
    # [b, half, tile, rg, r8, chunk, kq, kc] -> [b, tile, chunk, half, rg, kq, r8, kc]
    t = halves.view(b, 2, shape[1], WIDE_COLS // 8, 8, shape[2], 8, 4)
    return t.permute(0, 2, 5, 1, 3, 6, 4, 7).contiguous()


def pack_tf32_hilo(feat: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """The wide split-TF32 instance's f1 layout (see :func:`pack_tf32_hilo_plain`);
    on a CUDA float32 tensor one launch of the pack kernel. CPU tensors run the
    plain version."""
    if feat.device.type == "cpu":
        return pack_tf32_hilo_plain(feat, scale)
    if feat.dtype != torch.float32:
        raise ValueError(f"pack_tf32_hilo: float32 features only, got {feat.dtype}")
    feat = feat.contiguous()
    b, rows, c = feat.shape
    device = check_cuda_operands("pack_tf32_hilo", feat)
    out = torch.empty(tf32_hilo_packed_shape(b, rows, c), dtype=torch.float32, device=device)
    build().call("opp_pack_wide_tf32_hilo_f32", ptr(feat), ptr(out), b, rows, c, scale, stream_ptr(device))
    return out


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
    instance = k2_instance(feat0.shape[-1], dtype)
    inv_temp = 1.0 / (temperature + 1e-4)
    radd = None if row_add is None else row_add.float().contiguous()
    cadd = None if col_add is None else col_add.float().contiguous()
    if feat0.device.type == "cpu":
        return rowcol_stats_plain(*_scaled(feat0, feat1, feat_norm, dtype), inv_temp, radd, cadd)

    b, p, c = feat0.shape
    l = feat1.shape[1]
    if feat1.shape != (b, l, c):
        raise ValueError(f"dual_softmax_rowcol_stats: feat1 {tuple(feat1.shape)} vs feat0 {tuple(feat0.shape)}")
    scale = _scale(feat0, feat_norm)
    if instance == "tc":
        f0, f1, entry = pack_operand(feat0, scale), pack_operand(feat1, scale), "opp_rowcol_stats_bf16"
    elif instance == "wide_bf16":
        f0, f1 = pack_wide_operand(feat0, scale, PACK_ROWS), pack_wide_operand(feat1, scale, WIDE_COLS)
        entry = "opp_rowcol_stats_wide_bf16"
    else:  # f32 on the tensor cores in split TF32
        if feat0.dtype != torch.float32:  # scaled in the features' own type, as the plain version
            (feat0, feat1), scale = _scaled(feat0, feat1, feat_norm, torch.float32), 1.0
        if instance == "tf32x3":
            f0, f1 = pack_tf32_operand(feat0, scale), pack_tf32_operand(feat1, scale)
            entry = "opp_rowcol_stats_tf32x3"
        else:
            f0, f1 = pack_tf32_operand(feat0, scale, WIDE_CHANNELS), pack_tf32_hilo(feat1, scale)
            entry = "opp_rowcol_stats_wide_tf32x3"
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
        entry,
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
