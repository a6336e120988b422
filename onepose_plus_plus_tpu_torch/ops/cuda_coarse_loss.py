"""K5: the fused coarse focal loss over the dual softmax as hand-written CUDA kernels.

Replaces ``onepose_plus_plus_tpu/ops/pallas_coarse_loss.py::fused_coarse_focal_loss``
(its custom VJP ``_core``: the LSE pass, ``_loss_kernel``, ``_gsum_kernel`` and
``_dfeat_kernel``). Source: ``csrc/coarse_loss.cu``; the LSE pass is K2's
(``csrc/matching.cu``, entry ``opp_dual_lse_bf16``), as the TPU kernel shares
``pallas_matching._lse_kernel``.

It computes the log-space focal BCE of ``train/losses.py::coarse_focal_loss``
on the dual-softmax confidence without building the [B, P, L] matrix, using
``log conf[p, l] = 2 s[p, l] - colLSE[l] - rowLSE[p]`` (capped at -1e-6), at
the TPU kernel's precision: f0 and f1 are scaled by 1/sqrt(C) and rounded to
bf16, similarities accumulate in f32. The backward is analytic, with
g = dL/dlogconf (zero where the cap is active),
``dL/ds = 2 g - softmax_p * colsum(g) - softmax_l * rowsum(g)``, rounded to
bf16 before the two products with the features (f32 accumulation), and the
feature gradients rounded to bf16 before they are carried back through the
operands' scale in f32 (the TPU kernel's ``df.astype(bf16)`` in ``_core_bwd``).

What bounds it on the card: seven similarity-sized products on the tensor
cores (2*B*P*L*C FLOP each, ~59 GFLOP at the train shapes), then ~14
transcendentals per similarity element. Two instances by width
(:func:`k5_instance`), as K1 and K2 have, both on the tensor cores:

- **C <= 576, the resident tile.** Every pass runs on the tile of
  ``csrc/sim_tile_tc.cuh`` over operands packed once per forward
  (``ops/cuda_matching.py::pack_operand``, two launches that also scale and
  round the features, the backward scaling their gradients), recomputing its
  similarity tiles (flash-attention style). The feature gradients form dsim in
  the first product's registers and feed it to a second ``wgmma`` as the A
  operand, against the streamed tile read transposed: df0 runs one block per
  row tile over the column tiles, df1 one block per column tile over the row
  tiles on the transposed tile, so neither needs atomics or a
  [B, row tiles, L, C] partial, and the result is the same bit for bit from run
  to run. Column sums of g are per-row-tile partials merged in order, as K2's
  column statistics. The second product's accumulators hold 256 output
  channels; above that each 256-channel chunk is a block of its own that
  recomputes its similarity tiles (one more first product a chunk).
- **576 < C <= 4096 (K1's widest), the channel-streaming tile.** The operands
  are packed once by K2's wide pack (:func:`pack_wide_operand`: f0 in 64-row,
  f1 in 128-row tiles of 64-channel chunks) and serve K2's wide LSE pass
  (``opp_dual_lse_wide_bf16``) and K5's own passes alike. The loss and g sums
  run the same epilogues on ``csrc/sim_tile_wide.cuh``'s tile (128 columns a
  product). The feature gradients run in thread-block clusters of
  ``ceil(Cp / 256)`` blocks (Cp: C padded to 64), one cluster per 64-row tile
  of the own operand: each block holds 256 output channels and the products
  over those channels, the partial similarities are summed across the cluster
  in rank order through distributed shared memory, and each dsim element is
  formed once, rounded to bf16 and shared with every block of the cluster
  (``csrc/coarse_loss.cu``, ``dfeat_wide_kernel``).

The count normalisation and ``max_conf`` live in the wrapper, as in JAX; in
data-parallel training their sums, counts and maximum are the global
batch's (``parallel.comm``).
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from ..kernels import KERNEL_DTYPES, LAUNCHES, build, check_cuda_operands, ptr, stream_ptr
from ..parallel.comm import batch_max, batch_sum
from .cuda_matching import (PACK_ROWS, TC_MAX_CHANNELS, WIDE_CHANNELS, WIDE_COLS, pack_operand,
                            pack_wide_operand)

LOGCAP = -1e-6  # log conf <= log(1 - ~1e-6): the negative term's log1p stays finite
TC_CHUNK = 256  # output channels of one tensor-core feature-gradient block (csrc/coarse_loss.cu: MAXC, wdf::S)
WIDE_MAX_CHANNELS = 4096  # the wide instance's widest operand, K1's widest (csrc/coarse_loss.cu: MAX_C_WIDE)


def k5_instance(c: int) -> Tuple[str, int]:
    """The instance K5 runs at C channels on the card, and how many blocks
    share its feature gradients' output channels, 256 each:
    ``("tc", ceil(Cp / 256))`` on the resident tile up to 576 channels (Cp: C
    padded to 16; a block per 256-channel chunk), ``("wide", ceil(Cp / 256))``
    up to 4096 (Cp: C padded to 64; the blocks of one thread-block cluster).
    Wider raises: K1 stops at 4096 too, so no model past it can run its coarse
    transformer on the card."""
    if c <= 0:
        raise ValueError(f"coarse focal loss kernel: C={c}")
    if c <= TC_MAX_CHANNELS:
        cp = -(-c // 16) * 16
        return "tc", -(-cp // TC_CHUNK)
    if c <= WIDE_MAX_CHANNELS:
        cp = -(-c // WIDE_CHANNELS) * WIDE_CHANNELS
        return "wide", -(-cp // TC_CHUNK)
    raise ValueError(f"coarse focal loss kernel: C={c} > {WIDE_MAX_CHANNELS}, the widest coarse layer "
                     f"K1 runs (ops/cuda_encoder.py); no model this wide runs on the card")


def wide_slices(c: int) -> List[Tuple[int, int]]:
    """(first channel, width) of each block's output slice in a cluster of the
    wide instance's feature gradients (``csrc/coarse_loss.cu``: block j holds
    [256 j, 256 j + w_j) of C padded to 64; the last slice may be 64, 128 or 192
    wide). Its rank order is the order the partial similarities are summed in."""
    instance, n = k5_instance(c)
    if instance != "wide":
        raise ValueError(f"coarse focal loss kernel: C={c} does not run the wide instance")
    cp = -(-c // WIDE_CHANNELS) * WIDE_CHANNELS
    return [(TC_CHUNK * j, min(TC_CHUNK, cp - TC_CHUNK * j)) for j in range(n)]


def _focal_terms(conf: torch.Tensor, log_conf: torch.Tensor, gamma: float):
    """(pos, neg) terms of the log-space focal BCE, unweighted."""
    one_m = 1.0 - conf
    if gamma == 2.0:
        pg, ng = one_m * one_m, conf * conf
    else:
        pg, ng = one_m ** gamma, conf ** gamma
    return -pg * log_conf, -ng * torch.log1p(-conf)


class _Similarity(torch.autograd.Function):
    """s = f0 f1^T * inv_temp in f32, whose backward rounds as the TPU kernel's
    ``_dfeat_kernel`` and ``_core_bwd`` do: dsim = inv_temp * dL/ds rounded to
    bf16, the two products with the features in f32, each df rounded to bf16
    (then to the operands' type: the autograd of the cast that made them
    carries it on through the operands' scale in f32)."""

    @staticmethod
    def forward(ctx, f0, f1, inv_temp):
        ctx.save_for_backward(f0, f1)
        ctx.inv_temp = inv_temp
        return torch.einsum("bpc,blc->bpl", f0.float(), f1.float()) * inv_temp

    @staticmethod
    def backward(ctx, g_sim):
        f0, f1 = ctx.saved_tensors
        dsim = (g_sim * ctx.inv_temp).to(torch.bfloat16).float()
        df0 = torch.einsum("bpl,blc->bpc", dsim, f1.float())
        df1 = torch.einsum("bpl,bpc->blc", dsim, f0.float())
        return (df0.to(torch.bfloat16).to(f0.dtype), df1.to(torch.bfloat16).to(f1.dtype), None)


def coarse_focal_sums_plain(
    f0: torch.Tensor, f1: torch.Tensor, gt: torch.Tensor, inv_temp: float, alpha: float, gamma: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5's core (dense log-space path, autograd).

    f0 [B, P, C], f1 [B, L, C] already scaled and cast; gt [B, P] the GT column
    of each row (-1 = none). Returns (alpha * sum of positive terms,
    (1 - alpha) * sum of negative terms, max conf). Materialises [B, P, L].
    The feature gradients round as the kernels' do (:class:`_Similarity`).
    """
    sim = _Similarity.apply(f0, f1, inv_temp)
    raw = 2.0 * sim - torch.logsumexp(sim, dim=1, keepdim=True) - torch.logsumexp(sim, dim=2, keepdim=True)
    log_conf = torch.clamp(raw, max=LOGCAP)
    conf = torch.exp(log_conf)
    pos_t, neg_t = _focal_terms(conf, log_conf, gamma)
    is_pos = gt.long()[:, :, None] == torch.arange(f1.shape[1], device=f0.device)
    pos = alpha * torch.where(is_pos, pos_t, torch.zeros_like(pos_t)).sum()
    neg = (1.0 - alpha) * torch.where(is_pos, torch.zeros_like(neg_t), neg_t).sum()
    return pos, neg, conf.detach().max()


def _check(f0, f1, gt):
    b, p, c = f0.shape
    l = f1.shape[1]
    if f0.dtype not in KERNEL_DTYPES or f1.dtype not in KERNEL_DTYPES:
        raise ValueError("coarse focal loss kernel: operands must be float32 or bfloat16")
    if f1.shape != (b, l, c) or gt.shape != (b, p) or gt.dtype != torch.int32:
        raise ValueError(f"coarse focal loss kernel: f0 {tuple(f0.shape)}, f1 {tuple(f1.shape)}, "
                         f"gt {tuple(gt.shape)} {gt.dtype}")
    instance, _ = k5_instance(c)
    return check_cuda_operands("coarse focal loss", f0, f1, gt), b, p, l, c, instance


def _operands(f0, f1, scale, instance):
    """The kernels' operands, packed once (the pack scales and rounds to bf16):
    the resident tile's layout up to 576 channels, K2's wide layout above."""
    if instance == "tc":
        return pack_operand(f0, scale), pack_operand(f1, scale)
    return pack_wide_operand(f0, scale, PACK_ROWS), pack_wide_operand(f1, scale, WIDE_COLS)


# C entries of each instance: (LSE pass, forward, backward)
_ENTRIES = {
    "tc": ("opp_dual_lse_bf16", "opp_coarse_loss_fwd", "opp_coarse_loss_bwd"),
    "wide": ("opp_dual_lse_wide_bf16", "opp_coarse_loss_fwd_wide", "opp_coarse_loss_bwd_wide"),
}


class _CoarseFocalSums(torch.autograd.Function):
    """K5's core on CUDA tensors: forward operands (scale, bf16) + LSE + loss
    passes, backward gsum + df passes."""

    @staticmethod
    def forward(ctx, f0, f1, gt, inv_temp, alpha, gamma, scale):
        device, b, p, l, c, instance = _check(f0, f1, gt)
        lse_entry, fwd_entry, _ = _ENTRIES[instance]
        lib = build()
        f32 = torch.float32
        row_lse = torch.empty((b, p), dtype=f32, device=device)
        col_lse = torch.empty((b, l), dtype=f32, device=device)
        part = torch.empty((b, lib.lib.opp_rowcol_row_tiles(p), l), dtype=f32, device=device)
        pos, neg, mx = (torch.empty((b, p), dtype=f32, device=device) for _ in range(3))
        stream = stream_ptr(device)
        f0p, f1p = _operands(f0, f1, scale, instance)
        lib.call(lse_entry, ptr(f0p), ptr(f1p), None, None, ptr(row_lse), ptr(col_lse),
                 ptr(part), b, p, l, c, inv_temp, stream)
        lib.call(fwd_entry, ptr(f0p), ptr(f1p), ptr(gt), ptr(row_lse), ptr(col_lse),
                 ptr(pos), ptr(neg), ptr(mx), b, p, l, c, inv_temp, alpha, gamma, stream)
        LAUNCHES["K5_coarse_loss"] += 1
        ctx.save_for_backward(f0p, f1p, gt, row_lse, col_lse)
        ctx.consts = (inv_temp, alpha, gamma, b, p, l, c, scale, f0.dtype, f1.dtype, instance)
        mx = mx.max()
        ctx.mark_non_differentiable(mx)
        return pos.sum(), neg.sum(), mx

    @staticmethod
    def backward(ctx, g_pos, g_neg, _g_mx):
        f0, f1, gt, row_lse, col_lse = ctx.saved_tensors  # the kernels' operands
        inv_temp, alpha, gamma, b, p, l, c, scale, dt0, dt1, instance = ctx.consts
        device = f0.device
        lib = build()
        f32 = torch.float32
        coef = torch.stack([g_pos, g_neg]).to(f32).contiguous()
        rowg = torch.empty((b, p), dtype=f32, device=device)
        colg = torch.empty((b, l), dtype=f32, device=device)
        colpart = torch.empty((b, lib.lib.opp_coarse_loss_row_tiles(p), l), dtype=f32, device=device)
        df0 = torch.empty((b, p, c), dtype=f32, device=device)
        df1 = torch.empty((b, l, c), dtype=f32, device=device)
        lib.call(_ENTRIES[instance][2], ptr(f0), ptr(f1), ptr(gt), ptr(row_lse), ptr(col_lse),
                 ptr(coef), ptr(rowg), ptr(colg), ptr(colpart), ptr(df0), ptr(df1),
                 b, p, l, c, inv_temp, alpha, gamma, scale, stream_ptr(device))
        LAUNCHES["K5_coarse_loss_bwd"] += 1
        return df0.to(dt0), df1.to(dt1), None, None, None, None, None


def coarse_focal_sums(
    f0: torch.Tensor,
    f1: torch.Tensor,
    gt: torch.Tensor,
    inv_temp: float,
    alpha: float,
    gamma: float,
    scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5's core: (alpha * pos sum, (1 - alpha) * neg sum, max conf) of the
    operands ``(f0 * scale)`` and ``(f1 * scale)`` rounded to bf16,
    differentiable in f0 [B, P, C] and f1 [B, L, C] (float32 or bfloat16). On
    the card the scale and the rounding happen in the operand pack. CPU tensors
    run the plain version."""
    if f0.device.type == "cpu":
        f0, f1 = ((f * scale if scale != 1.0 else f).to(torch.bfloat16) for f in (f0, f1))
        return coarse_focal_sums_plain(f0, f1, gt, inv_temp, alpha, gamma)
    return _CoarseFocalSums.apply(f0.contiguous(), f1.contiguous(), gt.to(torch.int32).contiguous(),
                                  inv_temp, alpha, gamma, scale)


def fused_coarse_focal_loss(
    feat0: torch.Tensor,
    feat1: torch.Tensor,
    gt_cell: torch.Tensor,
    temperature: float,
    alpha: float = 0.5,
    gamma: float = 2.0,
    pos_weight: float = 1.0,
    neg_weight: float = 1.0,
    feat_norm: str = "sqrt_feat_dim",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, max_conf) of the dual-softmax focal BCE, never building [P, L] on the card.

    Drop-in for ``coarse_focal_loss`` on the log-space confidence of
    ``dual_softmax_log_confidence(feat0, feat1, temperature)`` plus
    ``max(conf)``, at bf16 similarity precision. Differentiable in feat0
    [B, P, C] and feat1 [B, L, C]; ``max_conf`` is detached. gt_cell [B, P] is
    each row's GT column, -1 for none.
    """
    b, p, c = feat0.shape
    l = feat1.shape[1]
    if feat_norm == "sqrt_feat_dim":
        scale = 1.0 / (c ** 0.5)
    elif feat_norm in ("none", None):
        scale = 1.0
    else:
        raise ValueError(f"unknown feat_norm {feat_norm}")
    pos_sum, neg_sum, mx = coarse_focal_sums(feat0, feat1, gt_cell, 1.0 / (temperature + 1e-4), alpha,
                                             gamma, scale)
    local_pos = (gt_cell >= 0).sum()
    n_pos = batch_sum(local_pos)
    n_neg = batch_sum(b * p * l - local_pos)
    loss = (pos_weight * batch_sum(pos_sum) / n_pos.clamp(min=1)
            + neg_weight * batch_sum(neg_sum) / n_neg.clamp(min=1))
    return loss, batch_max(mx.detach())
