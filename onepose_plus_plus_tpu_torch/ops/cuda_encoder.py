"""K1: one LoFTR linear-attention encoder layer as a hand-written CUDA kernel.

Replaces ``onepose_plus_plus_tpu/ops/pallas_encoder.py::fused_encoder_layer``
(``_kv_stats_kernel`` and ``_apply_kernel``). Source: ``csrc/encoder.cu``.

The layer (reference ``loftr_module/transformer.py:7-58``): Q/K/V projection,
elu+1 linear attention, merge, LayerNorm, FFN over concat(x, msg) with ReLU,
LayerNorm, residual. The TPU kernel accumulates K'^T[V|1] over a sequential
grid; on Hopper the per-head K'^T V and sum K' are written as per-source-tile
partials and summed by a second small launch (deterministic, no atomics), then
one block per x tile runs the whole rest of the layer in shared memory.

What bounds it on the card: operations (20 C^2 per x row, 4 C^2 per source
row), every product computed in the kernel's own body. Three instances, chosen
by :func:`k1_instance` from the operand type and the width, all counted as
``K1_encoder_layer``:

- ``"tc"``: **bfloat16 operands at C = 256 with 8 heads** (both coarse
  transformers of the bench, inference and SfM configurations) run on the
  tensor cores through ``wgmma``: 64-row tiles, activations as bf16 tiles in
  shared memory, accumulators and every epilogue (elu+1, masks, division,
  LayerNorms, ReLU) in registers, the weights streamed from L2 by bulk copies
  into a ring of a few stages.
- ``"bf16"``: **bfloat16 operands at any other width** (C a multiple of 32 up
  to 256) run the CUDA-core kernels with bf16 weights, each product operand
  rounded to bf16 as it is staged.
- ``"f32"``: **float32 operands** (the demo, the f32 parity paths) keep exact
  f32 FMAs on the CUDA cores (no TF32), at the same widths.

A width outside these (C not a multiple of 32, above 256, or not divisible by
the heads) has no instance: the wrapper raises ``ValueError`` on the card,
where the model's router (``models/transformer.py::routes_to_k1``) sends it
all the same.

The weights reach the kernels packed (:func:`pack_encoder_weights`): for bf16
as byte images of the shared-memory chunks the tensor cores read, in the order
the kernel consumes them, for f32 as contiguous [in, out] matrices. A model
packs each layer once (``LoFTREncoderLayer.packed_weights``); the loose-tensor
entry :func:`fused_encoder_layer` packs at every call.

The reference's 1/S value pre-scaling and trailing *S cancel exactly and are
omitted, as in the TPU kernel. The residual stream stays float32 whatever the
operand type: only the operands of products are rounded to it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import KERNEL_DTYPES, LAUNCHES, build, check_cuda_operands, ptr, stream_ptr

_EPS = 1e-6
_LN_EPS = 1e-5
_TC_WIDTH, _TC_HEADS = 256, 8  # the tensor-core instance's only width
_CHUNK_K = 64  # input columns of one packed weight chunk


def k1_instance(c: int, nhead: int, dtype: torch.dtype) -> Optional[str]:
    """The K1 instance that runs a layer of width ``c`` with ``nhead`` heads on
    ``dtype`` operands: ``"tc"`` (tensor cores), ``"bf16"`` (CUDA cores, bf16
    operands), ``"f32"`` (CUDA cores, exact), or None where no instance takes it."""
    if dtype not in KERNEL_DTYPES or nhead <= 0 or c % 32 != 0 or not 0 < c <= 256 or c % nhead != 0:
        return None
    if dtype == torch.float32:
        return "f32"
    return "tc" if (c, nhead) == (_TC_WIDTH, _TC_HEADS) else "bf16"


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


@dataclass(frozen=True)
class PackedEncoderWeights:
    """One layer's weights as K1 reads them, for one operand type and device.

    ``width``: C. ``loose``: wq, wk, wv, wmerge, wmlp0, wmlp1 cast to ``dtype``
    in the [in, out] layout (what the plain version and the CUDA-core instances
    read; views where no copy was needed), empty where the tensor-core instance
    reads the chunk images instead. ``ln``: ln1 scale and bias, ln2 scale and
    bias in f32. ``stats`` / ``apply``: the bf16 chunk images of the
    tensor-core instance (else None). ``instance``: :func:`k1_instance`'s
    choice (None on the CPU, where the plain version runs).
    """

    dtype: torch.dtype
    nhead: int
    width: int
    loose: Tuple[torch.Tensor, ...]
    ln: Tuple[torch.Tensor, ...]
    stats: Optional[torch.Tensor] = None
    apply: Optional[torch.Tensor] = None
    instance: Optional[str] = None


def pack_weight_chunks(w_out_in: torch.Tensor) -> torch.Tensor:
    """A weight [N, K] in torch's Linear layout ([out, in]) as the chunks the
    tensor-core instance copies into shared memory: [K / 64, N / 8, 8, 8, 8]
    indexed (chunk, out group, in group, out % 8, in % 8), i.e. per chunk of 64
    input columns the 8 x 8 core matrices of the ``wgmma`` K-major layout, so
    that element (n, k) of a chunk lies at byte
    ``(n // 8) * 1024 + (k // 8) * 128 + (n % 8) * 16 + (k % 8) * 2``."""
    n, k = w_out_in.shape
    if n % 8 != 0 or k % _CHUNK_K != 0:
        raise ValueError(f"pack_weight_chunks: shape {(n, k)} needs N % 8 == 0 and K % 64 == 0")
    t = w_out_in.reshape(n // 8, 8, k // _CHUNK_K, 8, 8)  # [ng, nr, chunk, kg, kc]
    return t.permute(2, 0, 3, 1, 4).contiguous()


def pack_encoder_weights(
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
) -> PackedEncoderWeights:
    """Pack one layer's weights ([in, out] layout, as :func:`fused_encoder_layer`
    takes them) for operand type ``dtype`` on the weights' device."""
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"pack_encoder_weights: unsupported operand dtype {dtype}")
    c = wq.shape[0]
    for w, shape in ((wq, (c, c)), (wk, (c, c)), (wv, (c, c)), (wmerge, (c, c)),
                     (wmlp0, (2 * c, 2 * c)), (wmlp1, (2 * c, c))):
        if w.shape != shape:
            raise ValueError(f"pack_encoder_weights: weight {tuple(w.shape)} != {shape}")
    ln = tuple(p.float().contiguous() for p in (ln1_scale, ln1_bias, ln2_scale, ln2_bias))
    if any(p.shape != (c,) for p in ln):
        raise ValueError("pack_encoder_weights: LayerNorm parameters must be [C]")
    loose = tuple(w.to(dtype) for w in (wq, wk, wv, wmerge, wmlp0, wmlp1))
    if wq.device.type == "cpu":
        return PackedEncoderWeights(dtype, nhead, c, loose, ln)
    instance = k1_instance(c, nhead, dtype)
    if instance is None:
        raise ValueError(f"fused_encoder_layer: no K1 instance takes C = {c} with {nhead} heads "
                         f"(C must be a multiple of 32 up to 256, divisible by the heads)")
    if instance != "tc":
        return PackedEncoderWeights(dtype, nhead, c, tuple(w.contiguous() for w in loose), ln,
                                    instance=instance)
    q, k, v, m, w0, w1 = (w.t() for w in loose)  # torch Linear layout [out, in]
    stats = torch.cat([pack_weight_chunks(k), pack_weight_chunks(v)])
    # in the kernel's order: Q, merge, the FFN's first product by output half
    # (its input columns 0..C-1 meet x, C..2C-1 the LN1 output), its second
    apply = torch.cat([pack_weight_chunks(q), pack_weight_chunks(m), pack_weight_chunks(w0[:c]),
                       pack_weight_chunks(w0[c:]), pack_weight_chunks(w1)])
    return PackedEncoderWeights(dtype, nhead, c, (), ln, stats, apply, instance)


def fused_encoder_layer_packed(
    x: torch.Tensor,
    source: torch.Tensor,
    packed: PackedEncoderWeights,
    x_mask: Optional[torch.Tensor] = None,
    source_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`fused_encoder_layer` on weights packed beforehand: on a CUDA
    tensor, the kernel's launches and no cast or copy of a weight."""
    dtype, nhead = packed.dtype, packed.nhead
    x, source = x.float().contiguous(), source.float().contiguous()
    masks = [None if m is None else m.float().contiguous() for m in (x_mask, source_mask)]
    ln = packed.ln
    if x.device.type == "cpu":
        wq, wk, wv, wmerge, wmlp0, wmlp1 = packed.loose
        return encoder_layer_plain(
            x, source, wq, wk, wv, wmerge, ln[0], ln[1], wmlp0, wmlp1, ln[2], ln[3],
            masks[0], masks[1], nhead=nhead, dtype=dtype,
        )

    n, l, c = x.shape
    s = source.shape[1]
    if source.shape != (n, s, c):
        raise ValueError(f"fused_encoder_layer: source {tuple(source.shape)} vs x {tuple(x.shape)}")
    if k1_instance(c, nhead, dtype) is None:
        raise ValueError(f"fused_encoder_layer: unsupported C={c}, nhead={nhead}")
    if packed.width != c:
        raise ValueError(f"fused_encoder_layer: weights packed for C={packed.width}, x has C={c}")
    if masks[0] is not None and masks[0].shape != (n, l):
        raise ValueError("fused_encoder_layer: x_mask must be [N, L]")
    if masks[1] is not None and masks[1].shape != (n, s):
        raise ValueError("fused_encoder_layer: source_mask must be [N, S]")
    instance = packed.instance
    if instance == "tc":  # its bulk copies read 16-byte aligned rows
        x = x if x.data_ptr() % 16 == 0 else x.clone()
        source = source if source.data_ptr() % 16 == 0 else source.clone()
    weights = (packed.stats, packed.apply) if instance == "tc" else packed.loose
    operands = [x, source, *weights, *ln] + [m for m in masks if m is not None]
    device = check_cuda_operands("fused_encoder_layer", *operands)

    lib = build()
    hd = c // nhead
    y = torch.empty((n, l, c), dtype=torch.float32, device=device)
    if instance != "tc":
        n_tiles = lib.lib.opp_encoder_source_tiles(s)
        part = torch.empty((n, n_tiles, hd + 1, c), dtype=torch.float32, device=device)
        kv = torch.empty((n, c, hd + 1), dtype=torch.float32, device=device)
        lib.call(
            f"opp_encoder_layer_{instance}",
            ptr(x), ptr(source), *(ptr(w) for w in weights),
            ptr(ln[0]), ptr(ln[1]), ptr(ln[2]), ptr(ln[3]), ptr(masks[0]), ptr(masks[1]),
            ptr(part), ptr(kv), ptr(y), n, l, s, c, nhead, stream_ptr(device),
        )
    else:
        n_tiles = lib.lib.opp_encoder_tc_source_tiles(s)
        part = torch.empty((n, n_tiles, hd + 1, c), dtype=torch.float32, device=device)
        kv_image = torch.empty((n, nhead * 40 * hd), dtype=torch.bfloat16, device=device)
        lib.call(
            "opp_encoder_layer_tc",
            ptr(x), ptr(source), ptr(packed.stats), ptr(packed.apply),
            ptr(ln[0]), ptr(ln[1]), ptr(ln[2]), ptr(ln[3]), ptr(masks[0]), ptr(masks[1]),
            ptr(part), ptr(kv_image), ptr(y), n, l, s, stream_ptr(device),
        )
    LAUNCHES["K1_encoder_layer"] += 1
    return y


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
    kernel does). It also routes (:func:`k1_instance`): bfloat16 at C = 256
    with 8 heads to the tensor-core instance, bfloat16 at another width to the
    CUDA-core bf16 instance, float32 to the exact CUDA-core instance.
    Returns [N, L, C] float32. CPU tensors run the plain version. Packs the
    weights at every call; a caller that keeps its weights packs them once
    (:func:`pack_encoder_weights`) and calls :func:`fused_encoder_layer_packed`.
    """
    if dtype is None:
        dtype = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    packed = pack_encoder_weights(wq, wk, wv, wmerge, ln1_scale, ln1_bias, wmlp0, wmlp1,
                                  ln2_scale, ln2_bias, nhead=nhead, dtype=dtype)
    return fused_encoder_layer_packed(x, source, packed, x_mask, source_mask)
