"""K1: one LoFTR linear-attention encoder layer as a hand-written CUDA kernel.

Replaces ``onepose_plus_plus_tpu/ops/pallas_encoder.py::fused_encoder_layer``
(``_kv_stats_kernel`` and ``_apply_kernel``). Sources: ``csrc/encoder.cu``
(C = 256 with 8 heads), ``csrc/encoder_tcw.cu`` and ``csrc/encoder_tcw_tf32.cu``
(every other width, on ``csrc/tcw_plan.cuh`` and ``csrc/wgmma_gemm.cuh``).

The layer (reference ``loftr_module/transformer.py:7-58``): Q/K/V projection,
elu+1 linear attention, merge, LayerNorm, FFN over concat(x, msg) with ReLU,
LayerNorm, residual. The TPU kernel accumulates K'^T[V|1] over a sequential
grid; on Hopper the per-head K'^T V and sum K' are written as per-source-tile
partials and summed by a second small launch (deterministic, no atomics), then
one block per x tile runs the whole rest of the layer in shared memory.

What bounds it on the card: operations (20 C^2 per x row, 4 C^2 per source
row), every product computed in the kernel's own body, on the tensor cores.
Four instances, chosen by :func:`k1_instance` from the operand type and the
width, all counted as ``K1_encoder_layer``:

- ``"tc"``: **bfloat16 operands at C = 256 with 8 heads** (both coarse
  transformers of the bench, inference and SfM configurations) run on the
  tensor cores through ``wgmma``: 64-row tiles, activations as bf16 tiles in
  shared memory, accumulators and every epilogue (elu+1, masks, division,
  LayerNorms, ReLU) in registers, the weights streamed from L2 by bulk copies
  into a ring of a few stages.
- ``"tf32x3"``: **float32 operands at C = 256 with 8 heads** (the demo, the
  f32 parity paths) run the same layer on the tensor cores in split TF32:
  each projection and FFN product as three TF32 products of hi / lo halves
  (~2^-22 relative, f32 accuracy), activations as f32 tiles split into A
  fragments in registers, the weights packed once as hi and lo images; the
  per-head K'^T[V|1] and attention products in f32 FMAs on the CUDA cores.
- ``"tcw"``: **bfloat16 operands at every other width** (C a multiple of 32
  from 32 to 4096, any head count that divides it) run on the tensor cores as
  a chain of products (``csrc/encoder_tcw.cu``): every launch works on 64-row
  tiles, its operands bf16 images of ``wgmma`` chunks in device memory, C
  padded to 64 channels with zeros (:func:`tcw_padded`), the weights packed
  once ([column block][k chunk][128 out x 64 in],
  :func:`pack_weight_chunks_tcw`) and streamed by bulk copies; the stats as
  per-group partials of K'^T[V|1] reduced in group order, the LayerNorms from
  per-column-block (mean, M2) partials merged in block order; the attention's
  denominators as 16 rows of head sums (a head width that is a multiple of 8)
  or replicated per column over 64-column blocks (any other head width,
  :func:`tcw_replicated`).
- ``"tcw_tf32"``: **float32 operands at every other width** run the ``"tcw"``
  chain with every product as three TF32 products of hi / lo halves
  (``csrc/encoder_tcw_tf32.cu``): A operands f32 images of [64 rows, 32 k]
  chunks split in registers, B operands packed split, hi image then lo image
  ([column block][k chunk][128 out x 32 in], :func:`pack_weight_chunks_tcw_tf32`;
  V^T and the attention's B written so by their producers), the attention's
  k range over Q' an even number of chunks (:func:`tcw32_head_chunks`).

Together they take every C that is a multiple of 32 up to 4096 with any head
count that divides it: every width the JAX kernel takes (C % 128 == 0, head
width a multiple of 8) up to there, and the port's narrower ones. A width
outside these has no instance: the wrapper raises ``ValueError`` on the card,
where the model's router (``models/transformer.py::routes_to_k1``) sends it
all the same.

The weights reach the kernels packed (:func:`pack_encoder_weights`) as byte
images of the chunks the products read, in the order the kernels consume
them (bf16, or the TF32 hi and lo halves; :func:`chunk_images`). A model
packs each layer once (``LoFTREncoderLayer.packed_weights``); the loose-tensor
entry :func:`fused_encoder_layer` packs at every call.

The reference's 1/S value pre-scaling and trailing *S cancel exactly and are
omitted, as in the TPU kernel. The residual stream stays float32 whatever the
operand type: only the operands of products are rounded to it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import KERNEL_DTYPES, LAUNCHES, build, check_cuda_operands, ptr, stream_ptr, tf32_split

_EPS = 1e-6
_LN_EPS = 1e-5
_TC_WIDTH, _TC_HEADS = 256, 8  # the 256-channel instances' only width
_CHUNK_K = 64  # input columns of one packed bf16 weight chunk
_TF32_CHUNK_K = 8  # input columns of one packed split-TF32 weight chunk
TCW_MAX_WIDTH = 4096  # K1's widest layer (csrc/tcw_plan.cuh::takes)
TCW_BLOCK = 128  # output columns of a "tcw" product block (csrc/tcw_plan.cuh::BN)
TCW_REP_BLOCK = 64  # output columns of an attention block with replicated denominators (BR)
TCW_TILE = 64  # rows of a "tcw" tile, and channels of a k chunk
TCW_SUMS = 16  # rows of head sums in the attention's B otherwise (SUMS): the heads a block holds
TCW_SOURCE_GROUP = 16  # source chunks a "tcw" stats block sums (csrc/encoder_tcw.cu::SG)
TCW32_CHUNK = 32  # k columns of a "tcw_tf32" chunk (csrc/encoder_tcw_tf32.cu::KW)
TCW32_SOURCE_GROUP = 32  # source chunks a "tcw_tf32" stats block sums: 1024 rows, as "tcw"
TCW_FILL = 132  # stats blocks a launch should have at least: one an SM (csrc/tcw_plan.cuh::FILL)


def tcw_takes(c: int, nhead: int) -> bool:
    """Whether the tensor-core chains (``"tcw"``, ``"tcw_tf32"``) take
    (C, heads): C a multiple of 32 from 32 to 4096 and any head count that
    divides it (``tcw_plan.cuh::takes``)."""
    return c % 32 == 0 and 32 <= c <= TCW_MAX_WIDTH and nhead > 0 and c % nhead == 0


def k1_instance(c: int, nhead: int, dtype: torch.dtype) -> Optional[str]:
    """The K1 instance that runs a layer of width ``c`` with ``nhead`` heads on
    ``dtype`` operands: ``"tc"`` (bf16, C = 256 with 8 heads), ``"tf32x3"`` (f32
    in split TF32, the same width), ``"tcw"`` (bf16, every other width
    :func:`tcw_takes` names), ``"tcw_tf32"`` (f32 in split TF32, the same
    widths), all on the tensor cores; or None where no instance takes it."""
    if dtype not in KERNEL_DTYPES or not tcw_takes(c, nhead):
        return None
    if (c, nhead) == (_TC_WIDTH, _TC_HEADS):
        return "tc" if dtype == torch.bfloat16 else "tf32x3"
    return "tcw" if dtype == torch.bfloat16 else "tcw_tf32"


def tcw_padded(c: int) -> int:
    """C padded to a whole 64-channel tile: the channels of the chains'
    activation images and the input columns of their weight chunks, zero past
    C (``tcw_plan.cuh::padded``)."""
    return -(-c // TCW_TILE) * TCW_TILE


def tcw_replicated(hd: int) -> bool:
    """Whether the chains' attention keeps replicated denominators over
    64-column blocks (head widths that are not a multiple of 8) rather than 16
    rows of head sums over 128-column blocks (``tcw_plan.cuh::replicated``)."""
    return hd % 8 != 0


def tcw_value_blocks(i: int, c: int, hd: int) -> Tuple[int, int]:
    """The 128-column blocks [lo, hi] of V^T whose channels share a head with
    the channels below C of the stats' 64-channel tile i
    (``tcw_plan.cuh::value_blocks``)."""
    h_a, h_b = (TCW_TILE * i) // hd, (min(TCW_TILE * i + TCW_TILE, c) - 1) // hd
    return h_a * hd // TCW_BLOCK, ((h_b + 1) * hd - 1) // TCW_BLOCK


def tcw_source_chunks(c: int, nhead: int, n: int, s: int, chunk: int = TCW_TILE) -> int:
    """Source chunks a stats block sums in the chain with ``chunk``-channel k
    chunks (64: "tcw", 32: "tcw_tf32") for n batch elements of s source rows
    (``tcw_plan.cuh::Layout``): at most :data:`TCW_SOURCE_GROUP` /
    :data:`TCW32_SOURCE_GROUP`, fewer (an even count) where those groups would
    give stats blocks to less than half of :data:`TCW_FILL` SMs, and then as
    few as give every SM one."""
    hd, ck = c // nhead, tcw_padded(c) // TCW_TILE
    widest = max(hi - lo + 1 for lo, hi in (tcw_value_blocks(i, c, hd) for i in range(ck)))
    sc = -(-s // TCW_TILE) * (TCW_TILE // chunk)
    most = TCW32_SOURCE_GROUP if chunk == TCW32_CHUNK else TCW_SOURCE_GROUP
    blocks = widest * ck * n
    if 2 * blocks * -(-sc // most) >= TCW_FILL:
        return most
    return (-(-sc // -(-TCW_FILL // blocks)) + 1) // 2 * 2


def tcw_head_chunks(nb: int, c: int, hd: int, chunk: int = TCW_TILE,
                    block: int = TCW_BLOCK) -> Tuple[int, int, int, int]:
    """(h_first, h_last, k_lo, k_hi): the heads of the attention's column block
    nb (``block`` columns wide) and the k chunks [k_lo, k_hi) of ``chunk``
    channels of Q' it reads (``tcw_plan.cuh::head_chunks``)."""
    n0 = nb * block
    h_first, h_last = n0 // hd, (min(n0 + block, c) - 1) // hd
    return h_first, h_last, h_first * hd // chunk, -(-((h_last + 1) * hd) // chunk)


def tcw32_head_chunks(nb: int, c: int, hd: int, block: int = TCW_BLOCK) -> Tuple[int, int, int, int]:
    """:func:`tcw_head_chunks` of the "tcw_tf32" attention (32-channel chunks),
    its k range widened by one chunk where it spans an odd number, at the end
    if there is room in the padded width, else at the start (its product loop
    takes chunks in pairs; ``encoder_tcw_tf32.cu::head_chunks32``)."""
    h_first, h_last, k_lo, k_hi = tcw_head_chunks(nb, c, hd, TCW32_CHUNK, block)
    if (k_hi - k_lo) % 2:
        if k_hi < tcw_padded(c) // TCW32_CHUNK:
            k_hi += 1
        else:
            k_lo -= 1
    return h_first, h_last, k_lo, k_hi


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
    matmul: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = torch.matmul,
) -> torch.Tensor:
    """Plain PyTorch version of K1, in f32 arithmetic.

    ``dtype`` is the product operand type, as in the kernel and the TPU
    kernel: every weight and every activation that enters a product (x,
    source, K', V, Q', K'^T[V|1], msg, the LN1 output, the FFN hidden) is
    rounded to it; the LayerNorms and the residual stay f32. With
    ``torch.float64`` every operand, product and sum is float64 (the inputs
    and weights as they are): the layer an f32 instance approximates.
    ``matmul`` computes the two-operand products (x, source, msg, the LN1
    output and the FFN hidden times a weight), e.g.
    :func:`~onepose_plus_plus_tpu_torch.kernels.tf32x3_matmul` for the split
    TF32 arithmetic of the f32 tensor-core instances.
    """
    n, l, c = x.shape
    s = source.shape[1]
    hd = c // nhead
    acc = torch.float64 if dtype == torch.float64 else torch.float32

    def r(t):  # a product operand: rounded to dtype, computed in acc
        return t.to(dtype).to(acc)

    x32 = x.to(acc)
    xb, sb = r(x32), r(source)
    k = _elu_p1(matmul(sb, r(wk)))
    if source_mask is not None:
        k = k * source_mask.to(acc)[..., None]
    kh, vh = r(k).view(n, s, nhead, hd), r(matmul(sb, r(wv))).view(n, s, nhead, hd)
    kv = r(torch.einsum("nshd,nshe->nhde", kh, vh))
    ksum = r(kh.sum(dim=1))  # [N, H, D]
    q = _elu_p1(matmul(xb, r(wq)))
    if x_mask is not None:
        q = q * x_mask.to(acc)[..., None]
    qh = r(q).view(n, l, nhead, hd)
    num = torch.einsum("nlhd,nhde->nlhe", qh, kv)
    den = torch.einsum("nlhd,nhd->nlh", qh, ksum)[..., None]
    msg = r((num / (den + _EPS)).reshape(n, l, c))
    h1 = F.layer_norm(matmul(msg, r(wmerge)), (c,), ln1_scale.to(acc), ln1_bias.to(acc), _LN_EPS)
    a = r(torch.relu(matmul(torch.cat([xb, r(h1)], dim=-1), r(wmlp0))))
    h2 = F.layer_norm(matmul(a, r(wmlp1)), (c,), ln2_scale.to(acc), ln2_bias.to(acc), _LN_EPS)
    return x32 + h2


@dataclass(frozen=True)
class PackedEncoderWeights:
    """One layer's weights as K1 reads them, for one operand type and device.

    ``width``: C. ``loose``: wq, wk, wv, wmerge, wmlp0, wmlp1 cast to ``dtype``
    in the [in, out] layout (what the plain version reads, on the CPU; views
    where no copy was needed), empty on the card, where the kernels read the
    chunk images instead. ``ln``: ln1 scale and bias, ln2 scale and bias in
    f32. ``stats`` / ``apply``: the chunk images of the instance (bf16, or f32
    TF32 halves; for ``"tcw"`` / ``"tcw_tf32"`` [Wk; Wv] and Wq, Wmerge, W0, W1
    in :func:`pack_weight_chunks_tcw`'s / :func:`pack_weight_chunks_tcw_tf32`'s
    chunks; None on the CPU; :func:`chunk_images`).
    ``instance``: :func:`k1_instance`'s choice (None on the CPU, where the
    plain version runs).
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


def pack_weight_chunks_tcw(w_out_in: torch.Tensor) -> torch.Tensor:
    """A weight [N, K] in torch's Linear layout ([out, in]) as the chunks the
    "tcw" products copy: [ceil(N / 128), ceil(K / 64), 16, 8, 8, 8] indexed
    (column block, k chunk, out group, in group, out % 8, in % 8), out rows past
    N and input columns past K zero, so that element (n, k) lies in chunk
    (n // 128, k // 64) at byte ``((n % 128) // 8) * 1024 + ((k % 64) // 8) *
    128 + (n % 8) * 16 + (k % 8) * 2`` of its 16 KB: the ``wgmma`` K-major
    layout of a [128 out, 64 in] B operand."""
    n, k = w_out_in.shape
    if n % 8 != 0 or k % 8 != 0:
        raise ValueError(f"pack_weight_chunks_tcw: shape {(n, k)} needs N % 8 == 0 and K % 8 == 0")
    nb, kp = -(-n // TCW_BLOCK), tcw_padded(k)
    w = F.pad(w_out_in, (0, kp - k, 0, nb * TCW_BLOCK - n))
    t = w.reshape(nb, TCW_BLOCK // 8, 8, kp // TCW_TILE, 8, 8)  # [nb, ng, nr, kc, kg, kr]
    return t.permute(0, 3, 1, 4, 2, 5).contiguous()


def pack_weight_chunks_tf32(w_out_in: torch.Tensor) -> torch.Tensor:
    """A float32 weight [N, K] in torch's Linear layout ([out, in]) as the chunks
    the split-TF32 instance copies into shared memory: [K / 8, 2, N / 8, 2, 8, 4]
    indexed (chunk, half, out group, in group, out % 8, in % 4), half 0 the TF32
    hi part and half 1 the lo part (:func:`kernels.tf32_split`), so that element
    (n, k) of a chunk's half lies at byte ``(n // 8) * 256 + ((k % 8) // 4) * 128
    + (n % 8) * 16 + (k % 4) * 4``: the ``wgmma`` K-major layout of 4-byte values."""
    n, k = w_out_in.shape
    if n % 8 != 0 or k % _TF32_CHUNK_K != 0:
        raise ValueError(f"pack_weight_chunks_tf32: shape {(n, k)} needs N % 8 == 0 and K % 8 == 0")
    halves = []
    for half in tf32_split(w_out_in.float()):
        t = half.reshape(n // 8, 8, k // 8, 2, 4)  # [ng, nr, chunk, kg, kc]
        halves.append(t.permute(2, 0, 3, 1, 4))
    return torch.stack(halves, dim=1).contiguous()


def pack_weight_chunks_tcw_tf32(w_out_in: torch.Tensor) -> torch.Tensor:
    """A float32 weight [N, K] in torch's Linear layout ([out, in]) as the chunks
    the "tcw_tf32" products copy: [ceil(N / 128), Kp / 32, 2, 16, 8, 8, 4] with
    Kp = K padded to a multiple of 64 (an even chunk count), indexed (column
    block, k chunk, half, out group, in group, out % 8, in % 4), half 0 the TF32
    hi part and half 1 the lo part (:func:`kernels.tf32_split`), out rows past
    N and input columns past K zero, so that element (n, k) of a half lies in
    chunk (n // 128, k // 32) at byte ``((n % 128) // 8) * 1024 + ((k % 32) //
    4) * 128 + (n % 8) * 16 + (k % 4) * 4`` of that half's 16 KB: the ``wgmma``
    K-major layout of a [128 out, 32 in] B operand of 4-byte values."""
    n, k = w_out_in.shape
    if n % 8 != 0 or k % 4 != 0:
        raise ValueError(f"pack_weight_chunks_tcw_tf32: shape {(n, k)} needs N % 8 == 0 and K % 4 == 0")
    nb, kp = -(-n // TCW_BLOCK), tcw_padded(k)
    halves = []
    for half in tf32_split(F.pad(w_out_in.float(), (0, kp - k, 0, nb * TCW_BLOCK - n))):
        t = half.reshape(nb, TCW_BLOCK // 8, 8, kp // TCW32_CHUNK, 8, 4)  # [nb, ng, nr, kc, kg, kr]
        halves.append(t.permute(0, 3, 1, 4, 2, 5))
    return torch.stack(halves, dim=2).contiguous()


def chunk_images(instance: str, wq, wk, wv, wmerge, wmlp0, wmlp1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(stats, apply): a tensor-core instance's chunk images of one layer's
    weights ([in, out] layout, already of the operand type), in the order its
    kernels consume them."""
    q, k, v, m, w0, w1 = (w.t() for w in (wq, wk, wv, wmerge, wmlp0, wmlp1))  # Linear layout [out, in]
    if instance in ("tcw", "tcw_tf32"):
        pack = pack_weight_chunks_tcw if instance == "tcw" else pack_weight_chunks_tcw_tf32
        stats = pack(torch.cat([k, v]))  # K' and V: one product, N = 2C
        c, cp = q.shape[0], tcw_padded(q.shape[0])
        w0 = torch.cat([F.pad(w0[:, :c], (0, cp - c)), F.pad(w0[:, c:], (0, cp - c))], dim=1)  # [x | LN1], padded
        return stats, torch.cat([pack(w).reshape(-1) for w in (q, m, w0, w1)])
    pack = pack_weight_chunks if instance == "tc" else pack_weight_chunks_tf32
    c = q.shape[0]
    # in the kernel's order: Q, merge, the FFN's first product by output half
    # (its input columns 0..C-1 meet x, C..2C-1 the LN1 output), its second
    return torch.cat([pack(k), pack(v)]), torch.cat([pack(q), pack(m), pack(w0[:c]), pack(w0[c:]), pack(w1)])


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
                         f"(C must be a multiple of 32 up to {TCW_MAX_WIDTH}, divisible by the heads)")
    return PackedEncoderWeights(dtype, nhead, c, (), ln, *chunk_images(instance, *loose), instance)


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
    # the bulk copies read 16-byte aligned rows
    x = x if x.data_ptr() % 16 == 0 else x.clone()
    source = source if source.data_ptr() % 16 == 0 else source.clone()
    operands = [x, source, packed.stats, packed.apply, *ln] + [m for m in masks if m is not None]
    device = check_cuda_operands("fused_encoder_layer", *operands)

    lib = build()
    hd = c // nhead
    y = torch.empty((n, l, c), dtype=torch.float32, device=device)
    if instance in ("tcw", "tcw_tf32"):
        self_layer = x.data_ptr() == source.data_ptr() and l == s
        scratch_bytes = getattr(lib.lib, f"opp_encoder_{instance}_scratch_bytes")
        scratch = torch.empty(scratch_bytes(n, l, s, c, nhead, int(self_layer)), dtype=torch.uint8, device=device)
        lib.call(
            f"opp_encoder_layer_{instance}",
            ptr(x), ptr(source), ptr(packed.stats), ptr(packed.apply),
            ptr(ln[0]), ptr(ln[1]), ptr(ln[2]), ptr(ln[3]), ptr(masks[0]), ptr(masks[1]),
            ptr(scratch), ptr(y), n, l, s, c, nhead, stream_ptr(device),
        )
    elif instance == "tf32x3":
        n_tiles = lib.lib.opp_encoder_tc_source_tiles(s)
        part = torch.empty((n, n_tiles, hd + 1, c), dtype=torch.float32, device=device)
        kv = torch.empty((n, c, hd + 1), dtype=torch.float32, device=device)
        hid = torch.empty((n, lib.lib.opp_encoder_tc_source_tiles(l), 64, c), dtype=torch.float32,
                          device=device)
        lib.call(
            "opp_encoder_layer_tf32x3",
            ptr(x), ptr(source), ptr(packed.stats), ptr(packed.apply),
            ptr(ln[0]), ptr(ln[1]), ptr(ln[2]), ptr(ln[3]), ptr(masks[0]), ptr(masks[1]),
            ptr(part), ptr(kv), ptr(hid), ptr(y), n, l, s, stream_ptr(device),
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
    kernel does). It also routes (:func:`k1_instance`): C = 256 with 8 heads
    to the 256-channel tensor-core instance of the operand type (bfloat16, or
    float32 in split TF32), every other width :func:`tcw_takes` names to the
    tensor-core chain of the operand type.
    Returns [N, L, C] float32. CPU tensors run the plain version. Packs the
    weights at every call; a caller that keeps its weights packs them once
    (:func:`pack_encoder_weights`) and calls :func:`fused_encoder_layer_packed`.
    """
    if dtype is None:
        dtype = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    packed = pack_encoder_weights(wq, wk, wv, wmerge, ln1_scale, ln1_bias, wmlp0, wmlp1,
                                  ln2_scale, ln2_bias, nhead=nhead, dtype=dtype)
    return fused_encoder_layer_packed(x, source, packed, x_mask, source_mask)
