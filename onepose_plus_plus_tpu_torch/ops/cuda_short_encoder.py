"""K7: the encoder layer over many short sequences as a hand-written CUDA kernel.

Replaces ``experiments/pallas_short_encoder.py::fused_short_encoder_layer``
(``_short_kernel``). Source: ``csrc/short_encoder.cu``.

M independent sequences, x [M, L, C] each attending to its own source
[M, S, C], linear attention in the quadratic association order, exact by
associativity: per head, A = elu1(Q) elu1(K)^T [L, S], z = rowsum(A),
msg = (A V) / (z + 1e-6); then the merge, LayerNorm, the FFN over concat(x, h1)
with ReLU, LayerNorm and the f32 residual. The TPU kernel has no length-1
shortcut, so neither do these: with S = 1 the message is v * a / (a + 1e-6).

What bounds it on the card, and the design: see the source. One block takes a
few whole sequences and runs the whole layer in shared memory; the products
are FP32 FMAs on the CUDA cores.

No path of the JAX package runs the TPU kernel (the fine stage keeps its
eager layer there), so nothing in the port's model routes to K7 either:
:func:`fine_transformer_short` applies a ``LocalFeatureTransformer`` through
it, the workload the kernel was written for (the fine stage's [M, 1, C] and
[M, 25, C] streams).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import KERNEL_DTYPES, LAUNCHES, build, check_cuda_operands, ptr, stream_ptr
from .cuda_encoder import _elu_p1

_EPS = 1e-6
_LN_EPS = 1e-5
MAX_SMEM_BYTES = 232448  # dynamic shared memory a block may use on sm_90


def short_encoder_layer_plain(
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
    *,
    nhead: int = 8,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version of K7, in f32 arithmetic.

    ``dtype`` is the product operand type, as in the kernel and the TPU
    kernel: the weights and x (as the FFN's input), source, Q', K', A, V, the
    per-head message, h1 and the FFN hidden are rounded to it; z sums the f32
    A; the LayerNorms and the residual stay f32. With float32 nothing is
    rounded.
    """
    m, l, c = x.shape
    s = source.shape[1]
    hd = c // nhead

    def r(t):  # a product operand: rounded to dtype, computed in f32
        return t.to(dtype).float()

    x32 = x.float()
    xb, sb = r(x32), r(source.float())
    q = r(_elu_p1(xb @ r(wq))).view(m, l, nhead, hd)
    k = r(_elu_p1(sb @ r(wk))).view(m, s, nhead, hd)
    v = r(sb @ r(wv)).view(m, s, nhead, hd)
    a = torch.einsum("mlhd,mshd->mhls", q, k)
    z = a.sum(dim=-1).transpose(1, 2)[..., None]  # [M, L, H, 1]
    num = torch.einsum("mhls,mshd->mlhd", r(a), v)
    msg = r((num / (z + _EPS)).reshape(m, l, c))
    h1 = F.layer_norm(msg @ r(wmerge), (c,), ln1_scale.float(), ln1_bias.float(), _LN_EPS)
    w0 = r(wmlp0)
    hidden = r(torch.relu(xb @ w0[:c] + r(h1) @ w0[c:]))
    h2 = F.layer_norm(hidden @ r(wmlp1), (c,), ln2_scale.float(), ln2_bias.float(), _LN_EPS)
    return x32 + h2


def fused_short_encoder_layer(
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
    *,
    nhead: int = 8,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """One encoder layer over M short sequences: x [M, L, C] attends to source [M, S, C].

    Weights use the [in, out] layout: wq/wk/wv/wmerge [C, C], wmlp0 [2C, 2C]
    (input concat(x, h1)), wmlp1 [2C, C]; LayerNorm parameters [C]. ``dtype``
    (float32 or bfloat16; default x's dtype when it is bfloat16, else float32;
    the TPU kernel always used bfloat16) is the product operand type. Returns
    [M, L, C] float32. CPU tensors run the plain version.
    """
    if dtype is None:
        dtype = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"fused_short_encoder_layer: unsupported operand dtype {dtype}")
    x, source = x.float().contiguous(), source.float().contiguous()
    wq, wk, wv, wmerge, wmlp0, wmlp1 = (
        w.to(dtype).contiguous() for w in (wq, wk, wv, wmerge, wmlp0, wmlp1)
    )
    ln = [p.float().contiguous() for p in (ln1_scale, ln1_bias, ln2_scale, ln2_bias)]
    if x.device.type == "cpu":
        return short_encoder_layer_plain(
            x, source, wq, wk, wv, wmerge, ln[0], ln[1], wmlp0, wmlp1, ln[2], ln[3],
            nhead=nhead, dtype=dtype,
        )

    m, l, c = x.shape
    s = source.shape[1]
    if source.shape != (m, s, c) or m == 0 or l == 0 or s == 0:
        raise ValueError(f"fused_short_encoder_layer: source {tuple(source.shape)} vs x {tuple(x.shape)}")
    if c % 32 != 0 or c > 1024 or c % nhead != 0:
        raise ValueError(f"fused_short_encoder_layer: unsupported C={c}, nhead={nhead}")
    for w, shape in ((wq, (c, c)), (wk, (c, c)), (wv, (c, c)), (wmerge, (c, c)),
                     (wmlp0, (2 * c, 2 * c)), (wmlp1, (2 * c, c))):
        if w.shape != shape:
            raise ValueError(f"fused_short_encoder_layer: weight {tuple(w.shape)} != {shape}")
    if any(p.shape != (c,) for p in ln):
        raise ValueError("fused_short_encoder_layer: LayerNorm parameters must be [C]")
    device = check_cuda_operands("fused_short_encoder_layer", x, source, wq, wk, wv, wmerge,
                                 wmlp0, wmlp1, *ln)

    lib = build()
    smem = lib.lib.opp_short_encoder_smem_bytes(l, s, c, nhead)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"fused_short_encoder_layer: L={l}, S={s}, C={c} need {smem} bytes of "
                         f"shared memory a block, more than {MAX_SMEM_BYTES}")
    y = torch.empty((m, l, c), dtype=torch.float32, device=device)
    lib.call(
        f"opp_short_encoder_{KERNEL_DTYPES[dtype]}",
        ptr(x), ptr(source), ptr(wq), ptr(wk), ptr(wv), ptr(wmerge), ptr(wmlp0), ptr(wmlp1),
        ptr(ln[0]), ptr(ln[1]), ptr(ln[2]), ptr(ln[3]), ptr(y), m, l, s, c, nhead,
        stream_ptr(device),
    )
    LAUNCHES["K7_short_encoder"] += 1
    return y


def fine_transformer_short(transformer, feat0: torch.Tensor,
                           feat1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply every layer of a ``LocalFeatureTransformer`` through K7, in its
    self/cross order, with each layer's own weights and compute dtype.

    The fine stage's streams, feat0 [M, 1, C] (the 3D descriptors) and feat1
    [M, W*W, C] (the windows), make four launches per (self, cross) pair at
    (L, S) = (1, 1), (W², W²), (1, W²), (W², 1). Returns f32 streams.
    """
    for layer, name in zip(transformer.layers, transformer.cfg.layer_sequence):
        w = layer.kernel_weights()
        run = lambda a, b: fused_short_encoder_layer(a, b, *w, nhead=layer.nhead,  # noqa: E731
                                                     dtype=layer.dtype)
        if name == "self":
            feat0, feat1 = run(feat0, feat0), run(feat1, feat1)
        elif name == "cross":
            feat0, feat1 = run(feat0, feat1), run(feat1, feat0)
        else:
            raise ValueError(name)
    return feat0, feat1
