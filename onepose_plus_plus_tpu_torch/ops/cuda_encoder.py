"""K1: one LoFTR linear-attention encoder layer as a hand-written CUDA kernel.

Replaces ``onepose_plus_plus_tpu/ops/pallas_encoder.py::fused_encoder_layer``
(``_kv_stats_kernel`` and ``_apply_kernel``). Source: ``csrc/encoder.cu``.

The layer (reference ``loftr_module/transformer.py:7-58``): Q/K/V projection,
elu+1 linear attention, merge, LayerNorm, FFN over concat(x, msg) with ReLU,
LayerNorm, residual. The TPU kernel accumulates K'^T[V|1] over a sequential
grid; on Hopper the per-head K'^T V and sum K' are written as per-source-tile
partials and summed by a second small launch (deterministic, no atomics), then
one block per x tile runs the whole rest of the layer in shared memory.

What bounds it on the card: FP32 FMA throughput of the CUDA cores (every
projection and FFN product is computed in the kernel's own body, ~10 C^2
multiply-adds per row); weights are reread from L2 by every block. The design
stages each tile in shared memory and reads it as float4 broadcasts (one
shared load per four FMAs); tensor cores are later work. Only the coarse stage
(sequences of 256 tokens or more, linear attention, inference) runs it.

The reference's 1/S value pre-scaling and trailing *S cancel exactly and are
omitted, as in the TPU kernel. The residual stream stays float32 whatever the
operand type: only the operands of products are rounded to it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import KERNEL_DTYPES, LAUNCHES, build, check_cuda_operands, ptr, stream_ptr

_EPS = 1e-6
_LN_EPS = 1e-5


def _elu_p1(x: torch.Tensor) -> torch.Tensor:
    """elu(x) + 1 as the kernel computes it: where(x > 0, x + 1, exp(x))."""
    return torch.where(x > 0, x + 1.0, torch.exp(x))


def encoder_layer_plain(
    x: torch.Tensor,
    source: torch.Tensor,
    wq: torch.Tensor,
    wk: torch.Tensor,
    wv: torch.Tensor,
    wmerge: torch.Tensor,
    ln1_scale: torch.Tensor,
    ln1_bias: torch.Tensor,
    wmlp0: torch.Tensor,
    wmlp1: torch.Tensor,
    ln2_scale: torch.Tensor,
    ln2_bias: torch.Tensor,
    x_mask: Optional[torch.Tensor] = None,
    source_mask: Optional[torch.Tensor] = None,
    *,
    nhead: int = 8,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version of K1, in f32 arithmetic.

    ``dtype`` is the product operand type, as in the kernel and the TPU
    kernel: every weight and every activation that enters a product (x,
    source, K', V, Q', K'^T[V|1], msg, the LN1 output, the FFN hidden) is
    rounded to it; the LayerNorms and the residual stay f32.
    """
    n, l, c = x.shape
    s = source.shape[1]
    hd = c // nhead

    def r(t):  # a product operand: rounded to dtype, computed in f32
        return t.to(dtype).float()

    x32 = x.float()
    xb, sb = r(x32), r(source.float())
    k = _elu_p1(sb @ r(wk))
    if source_mask is not None:
        k = k * source_mask.float()[..., None]
    kh, vh = r(k).view(n, s, nhead, hd), r(sb @ r(wv)).view(n, s, nhead, hd)
    kv = r(torch.einsum("nshd,nshe->nhde", kh, vh))
    ksum = r(kh.sum(dim=1))  # [N, H, D]
    q = _elu_p1(xb @ r(wq))
    if x_mask is not None:
        q = q * x_mask.float()[..., None]
    qh = r(q).view(n, l, nhead, hd)
    num = torch.einsum("nlhd,nhde->nlhe", qh, kv)
    den = torch.einsum("nlhd,nhd->nlh", qh, ksum)[..., None]
    msg = r((num / (den + _EPS)).reshape(n, l, c))
    h1 = F.layer_norm(msg @ r(wmerge), (c,), ln1_scale.float(), ln1_bias.float(), _LN_EPS)
    a = r(torch.relu(torch.cat([xb, r(h1)], dim=-1) @ r(wmlp0)))
    h2 = F.layer_norm(a @ r(wmlp1), (c,), ln2_scale.float(), ln2_bias.float(), _LN_EPS)
    return x32 + h2


def fused_encoder_layer(
    x: torch.Tensor,
    source: torch.Tensor,
    wq: torch.Tensor,
    wk: torch.Tensor,
    wv: torch.Tensor,
    wmerge: torch.Tensor,
    ln1_scale: torch.Tensor,
    ln1_bias: torch.Tensor,
    wmlp0: torch.Tensor,
    wmlp1: torch.Tensor,
    ln2_scale: torch.Tensor,
    ln2_bias: torch.Tensor,
    x_mask: Optional[torch.Tensor] = None,
    source_mask: Optional[torch.Tensor] = None,
    *,
    nhead: int = 8,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """One encoder layer, x [N, L, C] attends to source [N, S, C].

    Weights use the [in, out] layout: wq/wk/wv/wmerge [C, C], wmlp0 [2C, 2C]
    (input concat(x, msg)), wmlp1 [2C, C]; LayerNorm parameters [C]. Masks are
    [N, L] / [N, S] validity. ``dtype`` (float32 or bfloat16, default: x's
    dtype when it is bfloat16, else float32) is the product operand type: the
    weights are cast to it and every product operand is rounded to it, while
    x and source are read as f32 and the residual adds the f32 x (as the TPU
    kernel does). Returns [N, L, C] float32. CPU tensors run the plain version.
    """
    if dtype is None:
        dtype = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"fused_encoder_layer: unsupported operand dtype {dtype}")
    x, source = x.float().contiguous(), source.float().contiguous()
    wq, wk, wv, wmerge, wmlp0, wmlp1 = (
        w.to(dtype).contiguous() for w in (wq, wk, wv, wmerge, wmlp0, wmlp1)
    )
    ln = [p.float().contiguous() for p in (ln1_scale, ln1_bias, ln2_scale, ln2_bias)]
    masks = [None if m is None else m.float().contiguous() for m in (x_mask, source_mask)]
    if x.device.type == "cpu":
        return encoder_layer_plain(
            x, source, wq, wk, wv, wmerge, ln[0], ln[1], wmlp0, wmlp1, ln[2], ln[3],
            masks[0], masks[1], nhead=nhead, dtype=dtype,
        )

    n, l, c = x.shape
    s = source.shape[1]
    if source.shape != (n, s, c):
        raise ValueError(f"fused_encoder_layer: source {tuple(source.shape)} vs x {tuple(x.shape)}")
    if c % 32 != 0 or c > 256 or c % nhead != 0:
        raise ValueError(f"fused_encoder_layer: unsupported C={c}, nhead={nhead}")
    for w, shape in ((wq, (c, c)), (wk, (c, c)), (wv, (c, c)), (wmerge, (c, c)),
                     (wmlp0, (2 * c, 2 * c)), (wmlp1, (2 * c, c))):
        if w.shape != shape:
            raise ValueError(f"fused_encoder_layer: weight {tuple(w.shape)} != {shape}")
    if any(p.shape != (c,) for p in ln):
        raise ValueError("fused_encoder_layer: LayerNorm parameters must be [C]")
    if masks[0] is not None and masks[0].shape != (n, l):
        raise ValueError("fused_encoder_layer: x_mask must be [N, L]")
    if masks[1] is not None and masks[1].shape != (n, s):
        raise ValueError("fused_encoder_layer: source_mask must be [N, S]")
    operands = [x, source, wq, wk, wv, wmerge, wmlp0, wmlp1, *ln]
    operands += [m for m in masks if m is not None]
    device = check_cuda_operands("fused_encoder_layer", *operands)

    lib = build()
    hd = c // nhead
    n_tiles = lib.lib.opp_encoder_source_tiles(s)
    part = torch.empty((n, n_tiles, hd + 1, c), dtype=torch.float32, device=device)
    kv = torch.empty((n, c, hd + 1), dtype=torch.float32, device=device)
    y = torch.empty((n, l, c), dtype=torch.float32, device=device)
    lib.call(
        f"opp_encoder_layer_{KERNEL_DTYPES[dtype]}",
        ptr(x), ptr(source), ptr(wq), ptr(wk), ptr(wv), ptr(wmerge), ptr(wmlp0), ptr(wmlp1),
        ptr(ln[0]), ptr(ln[1]), ptr(ln[2]), ptr(ln[3]), ptr(masks[0]), ptr(masks[1]),
        ptr(part), ptr(kv), ptr(y), n, l, s, c, nhead, stream_ptr(device),
    )
    LAUNCHES["K1_encoder_layer"] += 1
    return y
