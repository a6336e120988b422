"""K7: the encoder layer over many short sequences as a hand-written CUDA kernel.

Replaces ``experiments/pallas_short_encoder.py::fused_short_encoder_layer``
(``_short_kernel``). Source: ``csrc/short_encoder.cu``.

M independent sequences, x [M, L, C] each attending to its own source
[M, S, C], linear attention in the quadratic association order, exact by
associativity: per head, A = elu1(Q) elu1(K)^T [L, S], z = rowsum(A),
msg = (A V) / (z + 1e-6); then the merge, LayerNorm, the FFN over concat(x, h1)
with ReLU, LayerNorm and the f32 residual. The TPU kernel has no length-1
shortcut, so neither do these: with S = 1 the message is v * a / (a + 1e-6).

What bounds it on the card, and the design: see the source. Three
instances, chosen by :func:`k7_instance` and all counted as
``K7_short_encoder``:

- ``"tc"``: **bfloat16 operands at C = 128 with 8 heads** (the fine
  transformer's width), L and S up to 128: the tensor cores through
  ``wgmma``. A 128-row tile holds G whole sequences (:func:`short_tile_plan`;
  :func:`short_tile_rows` is the kernel's row arithmetic in PyTorch), two
  warpgroups share one ring of weight chunks packed once per layer
  (:func:`pack_short_encoder_weights`), and the per-head attention runs as
  block-diagonal products masked to each row's own sequence.
- ``"bf16"`` / ``"f32"``: every other case (f32 operands, another width,
  longer sequences): one block takes a few whole sequences and runs the
  whole layer in shared memory in FP32 FMAs on the CUDA cores.

No path of the JAX package runs the TPU kernel (the fine stage keeps its
eager layer there), so nothing in the port's model routes to K7 either:
:func:`fine_transformer_short` applies a ``LocalFeatureTransformer`` through
it, the workload the kernel was written for (the fine stage's [M, 1, C] and
[M, 25, C] streams).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import KERNEL_DTYPES, LAUNCHES, build, check_cuda_operands, ptr, stream_ptr
from .cuda_encoder import _elu_p1, pack_weight_chunks

_EPS = 1e-6
_LN_EPS = 1e-5
MAX_SMEM_BYTES = 232448  # dynamic shared memory a block may use on sm_90
TC_WIDTH, TC_HEADS = 128, 8  # the tensor-core instance's only width
TILE_ROWS = 128  # x (and source) rows of a tensor-core tile: two m64 halves


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


def short_tile_plan(m: int, l: int, s: int) -> Optional[Tuple[int, int]]:
    """(G, tiles) of the tensor-core instance: G whole sequences a 128-row tile
    (their G L x rows and G S source rows each fit), ceil(M / G) tiles; None
    where one sequence does not fit (L or S above 128)."""
    g = min(TILE_ROWS // l, TILE_ROWS // s)
    return (g, -(-m // g)) if g > 0 else None


def short_tile_rows(m: int, l: int, s: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The tensor-core kernel's rows, tile by tile: (x_rows, src_rows, x_seq,
    src_seq), each [tiles, 128]. Tile i holds sequences [G i, G i + G); its
    row r is x row (G i) L + r of the flat [M L] rows while r < g_n L (g_n the
    tile's sequences, G but in the last tile), else padding (-1); the same for
    the source with S. x_seq / src_seq: the sequence of each row within the
    tile (r // L, r // S), -1 on padding: the attention keeps the entries
    where the two agree."""
    g, n_tiles = short_tile_plan(m, l, s)
    tile = torch.arange(n_tiles)[:, None]
    r = torch.arange(TILE_ROWS)[None, :]
    g_n = torch.clamp(m - g * tile, max=g)

    def rows(n):
        ok = r < g_n * n
        return torch.where(ok, g * tile * n + r, -1), torch.where(ok, r // n, -1)

    (x_rows, x_seq), (src_rows, src_seq) = rows(l), rows(s)
    return x_rows, src_rows, x_seq, src_seq


def k7_instance(c: int, nhead: int, dtype: torch.dtype, l: int, s: int) -> str:
    """The K7 instance for a layer of width ``c`` with ``nhead`` heads over
    sequences of length ``l`` attending to ``s``: ``"tc"`` (tensor cores, bf16
    operands at C = 128 with 8 heads, L and S up to 128), else the CUDA-core
    instance of the operand type, ``"bf16"`` or ``"f32"``."""
    if (dtype == torch.bfloat16 and (c, nhead) == (TC_WIDTH, TC_HEADS)
            and short_tile_plan(1, l, s) is not None):
        return "tc"
    return KERNEL_DTYPES[dtype]


def pack_short_weight_chunks(wq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor,
                             wmerge: torch.Tensor, wmlp0: torch.Tensor,
                             wmlp1: torch.Tensor) -> torch.Tensor:
    """One layer's bf16 weights ([in, out] layout) as the tensor-core
    instance's 20 chunks, in the order it multiplies them: K, V, Q and merge
    (two chunks of 64 input columns each), the FFN's first product by output
    half (its input columns 0..127 meet x, 128..255 the LN1 output; four
    chunks each), its second (four). Each chunk [128 out, 64 in] is
    :func:`~.cuda_encoder.pack_weight_chunks`' byte image: element (n, k) at
    byte ``(n // 8) * 1024 + (k // 8) * 128 + (n % 8) * 16 + (k % 8) * 2``.
    Returns [20, 16, 8, 8, 8] bf16."""
    c = wq.shape[0]
    parts = [wk.t(), wv.t(), wq.t(), wmerge.t(), wmlp0[:, :c].t(), wmlp0[:, c:].t(), wmlp1.t()]
    return torch.cat([pack_weight_chunks(w.to(torch.bfloat16)) for w in parts])


@dataclass(frozen=True)
class PackedShortEncoderWeights:
    """One layer's weights as K7 reads them, for one operand type and device.

    ``loose``: wq, wk, wv, wmerge, wmlp0, wmlp1 in ``dtype``, [in, out],
    contiguous (the plain version and the CUDA-core instances). ``ln``: ln1
    scale and bias, ln2 scale and bias in f32. ``chunks``: the tensor-core
    instance's 20 chunk images (:func:`pack_short_weight_chunks`) where it can
    run them (bf16 operands at C = 128 with 8 heads, on the card), else None.
    """

    dtype: torch.dtype
    nhead: int
    width: int
    loose: Tuple[torch.Tensor, ...]
    ln: Tuple[torch.Tensor, ...]
    chunks: Optional[torch.Tensor] = None


def pack_short_encoder_weights(
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
) -> PackedShortEncoderWeights:
    """Pack one layer's weights ([in, out] layout, as
    :func:`fused_short_encoder_layer` takes them) for operand type ``dtype`` on
    the weights' device."""
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"fused_short_encoder_layer: unsupported operand dtype {dtype}")
    c = wq.shape[0]
    for w, shape in ((wq, (c, c)), (wk, (c, c)), (wv, (c, c)), (wmerge, (c, c)),
                     (wmlp0, (2 * c, 2 * c)), (wmlp1, (2 * c, c))):
        if w.shape != shape:
            raise ValueError(f"fused_short_encoder_layer: weight {tuple(w.shape)} != {shape}")
    ln = tuple(p.float().contiguous() for p in (ln1_scale, ln1_bias, ln2_scale, ln2_bias))
    if any(p.shape != (c,) for p in ln):
        raise ValueError("fused_short_encoder_layer: LayerNorm parameters must be [C]")
    loose = tuple(w.to(dtype).contiguous() for w in (wq, wk, wv, wmerge, wmlp0, wmlp1))
    chunks = None
    if wq.device.type != "cpu" and dtype == torch.bfloat16 and (c, nhead) == (TC_WIDTH, TC_HEADS):
        chunks = pack_short_weight_chunks(*loose)
    return PackedShortEncoderWeights(dtype, nhead, c, loose, ln, chunks)


def fused_short_encoder_layer_packed(x: torch.Tensor, source: torch.Tensor,
                                     packed: PackedShortEncoderWeights) -> torch.Tensor:
    """:func:`fused_short_encoder_layer` on weights packed beforehand: on a
    CUDA tensor, one launch and no cast or copy of a weight. ``source is x``
    (a self layer) lets the tensor-core instance read one tile for both."""
    dtype, nhead = packed.dtype, packed.nhead
    self_layer = source is x
    x = x.float().contiguous()
    source = x if self_layer else source.float().contiguous()
    wq, wk, wv, wmerge, wmlp0, wmlp1 = packed.loose
    ln = packed.ln
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
    if packed.width != c:
        raise ValueError(f"fused_short_encoder_layer: weights packed for C={packed.width}, x has C={c}")
    lib = build()
    instance = k7_instance(c, nhead, dtype, l, s)
    y = torch.empty((m, l, c), dtype=torch.float32, device=x.device)
    if instance == "tc":
        if packed.chunks is None:
            raise ValueError("fused_short_encoder_layer: bf16 weights at C = 128 packed without "
                             "the tensor-core chunks (packed on another device)")
        if x.data_ptr() % 16 or source.data_ptr() % 16:  # the kernel reads 16-byte vectors
            x = x.clone()
            source = x if self_layer else source.clone()
        device = check_cuda_operands("fused_short_encoder_layer", x, source, packed.chunks, *ln)
        g, _ = short_tile_plan(m, l, s)
        lib.call("opp_short_encoder_tc", ptr(x), ptr(source), ptr(packed.chunks), ptr(ln[0]),
                 ptr(ln[1]), ptr(ln[2]), ptr(ln[3]), ptr(y), m, l, s, g, int(self_layer),
                 stream_ptr(device))
    else:
        device = check_cuda_operands("fused_short_encoder_layer", x, source, *packed.loose, *ln)
        smem = lib.lib.opp_short_encoder_smem_bytes(l, s, c, nhead)
        if smem > MAX_SMEM_BYTES:
            raise ValueError(f"fused_short_encoder_layer: L={l}, S={s}, C={c} need {smem} bytes of "
                             f"shared memory a block, more than {MAX_SMEM_BYTES}")
        lib.call(
            f"opp_short_encoder_{instance}",
            ptr(x), ptr(source), ptr(wq), ptr(wk), ptr(wv), ptr(wmerge), ptr(wmlp0), ptr(wmlp1),
            ptr(ln[0]), ptr(ln[1]), ptr(ln[2]), ptr(ln[3]), ptr(y), m, l, s, c, nhead,
            stream_ptr(device),
        )
    LAUNCHES["K7_short_encoder"] += 1
    return y


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
    the TPU kernel always used bfloat16) is the product operand type; it also
    routes (:func:`k7_instance`). Returns [M, L, C] float32. CPU tensors run
    the plain version. Packs the weights at every call; a caller that keeps
    its weights packs them once (:func:`pack_short_encoder_weights`) and calls
    :func:`fused_short_encoder_layer_packed`.
    """
    if dtype is None:
        dtype = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    packed = pack_short_encoder_weights(wq, wk, wv, wmerge, ln1_scale, ln1_bias, wmlp0, wmlp1,
                                        ln2_scale, ln2_bias, nhead=nhead, dtype=dtype)
    return fused_short_encoder_layer_packed(x, source, packed)


def fine_transformer_short(transformer, feat0: torch.Tensor,
                           feat1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply every layer of a ``LocalFeatureTransformer`` through K7, in its
    self/cross order, with each layer's own weights and compute dtype, packed
    once a layer (``LoFTREncoderLayer.short_packed_weights``).

    The fine stage's streams, feat0 [M, 1, C] (the 3D descriptors) and feat1
    [M, W*W, C] (the windows), make four launches per (self, cross) pair at
    (L, S) = (1, 1), (W², W²), (1, W²), (W², 1). Returns f32 streams.
    """
    for layer, name in zip(transformer.layers, transformer.cfg.layer_sequence):
        packed = layer.short_packed_weights()
        if name == "self":
            feat0 = fused_short_encoder_layer_packed(feat0, feat0, packed)
            feat1 = fused_short_encoder_layer_packed(feat1, feat1, packed)
        elif name == "cross":
            feat0, feat1 = (fused_short_encoder_layer_packed(feat0, feat1, packed),
                            fused_short_encoder_layer_packed(feat1, feat0, packed))
        else:
            raise ValueError(name)
    return feat0, feat1
