"""The split-TF32 (3xTF32) instances of K1 and K2 without a GPU.

The f32 instances of K2 (``csrc/sim_tile_tf32.cuh``) and K1 (``csrc/encoder.cu``,
namespace ``tf``) take each product x y as x_lo y_hi + x_hi y_lo + x_hi y_hi of
TF32 halves on the tensor cores; above 576 channels K2's ``wide_tf32`` instance
(``csrc/sim_tile_wide.cuh``) does the same in pairs of 32-channel chunks. What can
be checked here: the plain version of the split (``kernels.tf32_split``, the rule
of ``csrc/wgmma.cuh::tf32_split``), the byte layouts the kernels' operands are
packed into, and, by emulating the three products in PyTorch, that the split
keeps K2's statistics inside the f32 tolerances where one TF32 product does not.
"""
import numpy as np
import pytest
import torch

from onepose_plus_plus_tpu_torch.kernels import tf32_round, tf32_split, tf32x3_matmul
from onepose_plus_plus_tpu_torch.ops.cuda_encoder import pack_weight_chunks_tf32
from onepose_plus_plus_tpu_torch.ops.cuda_matching import (
    pack_tf32_hilo,
    pack_tf32_operand,
    pack_tf32_operand_plain,
    rowcol_stats_plain,
    tf32_hilo_packed_shape,
    tf32_packed_shape,
)

torch.set_num_threads(2)


def _values(seed, n=100_000):
    """Normal values over many binades, with exact ties of the TF32 rounding."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * np.exp2(rng.integers(-30, 30, n))
    # half-way bit patterns of normal values: exponent, 10 kept mantissa bits, then 0x1000
    ties = ((rng.integers(100, 150, 1000, dtype=np.int64) << 23)
            | (rng.integers(0, 2 ** 10, 1000, dtype=np.int64) << 13) | 0x1000)
    x = np.concatenate([x.astype(np.float32), ties.astype(np.int32).view(np.float32)])
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_tf32_split_hi_and_lo_are_tf32_values(seed):
    """hi and lo have their low 13 bits zero (a TF32 value in an f32 container);
    hi is x rounded to nearest with ties away from zero, as cvt.rna."""
    x = _values(seed)
    hi, lo = tf32_split(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    # nearest: |x - hi| is at most half a TF32 step of |x| (2^-11 relative)
    assert bool(((x - hi).abs() <= x.abs() * 2.0 ** -11).all())
    # ties away from zero: a half-way pattern rounds to the larger magnitude
    ties = x[-1000:]
    assert bool((tf32_round(ties).abs() > ties.abs()).all())
    assert torch.equal(tf32_round(-ties), -tf32_round(ties))


@pytest.mark.parametrize("seed", [0, 1])
def test_tf32_split_reconstructs_x_to_2e21(seed):
    """hi + lo holds x to within 2^-21 relative (lo is the exact remainder, rounded to TF32)."""
    x = _values(seed).double()
    hi, lo = tf32_split(x.float())
    rel = ((hi.double() + lo.double()) - x).abs() / x.abs()
    assert rel.max().item() <= 2.0 ** -21
    # the remainder x - hi is exact in f32: only lo's own rounding is lost
    assert torch.equal((x.float() - hi).double(), x - hi.double())


@pytest.mark.parametrize("seed", [0, 1])
def test_tf32x3_matmul_keeps_f32_accuracy(seed):
    """Three TF32 products of the halves land as near a float64 product as an
    f32 one does (within 4x), where one TF32 product lands 100x further."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((64, 512)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((512, 48)).astype(np.float32))
    exact = a.double() @ b.double()
    err = {name: (y.double() - exact).abs().max().item()
           for name, y in (("f32", a @ b), ("split", tf32x3_matmul(a, b)),
                           ("single", tf32_round(a) @ tf32_round(b)))}
    assert err["split"] <= 4 * err["f32"], err
    assert err["single"] >= 100 * err["split"], err


def _numpy_unpack_tf32(packed: np.ndarray, rows: int, c: int) -> np.ndarray:
    """Element (r, k) of batch element b read at byte (r // 64) * 256 Cp +
    (k // 32) * 8192 + ((r % 64) // 8) * 1024 + ((k % 32) // 4) * 128 +
    (r % 8) * 16 + (k % 4) * 4 of its slab (Cp from the packed shape)."""
    b = packed.shape[0]
    cp = packed.shape[2] * 32
    flat = packed.reshape(b, -1)  # f32 words: byte offset / 4
    r = np.arange(rows)[:, None]
    k = np.arange(c)[None, :]
    byte = ((r // 64) * 256 * cp + (k // 32) * 8192 + ((r % 64) // 8) * 1024
            + ((k % 32) // 4) * 128 + (r % 8) * 16 + (k % 4) * 4)
    return flat[:, byte // 4]


@pytest.mark.parametrize("c", [32, 64, 200, 256])
@pytest.mark.parametrize("rows", [7, 130])
def test_pack_tf32_operand_matches_the_byte_formula(c, rows):
    """The split-TF32 instance of K2 reads its operands as scaled f32 in
    32-channel chunks of 64-row tiles, each chunk the K-major layout of
    4-byte values; the plain pack (the CPU's) matches that byte formula bit
    for bit, and everything else is zero padding."""
    rng = np.random.default_rng(c + rows)
    feat = torch.from_numpy(rng.standard_normal((2, rows, c)).astype(np.float32))
    scale = 1.0 / c ** 0.5
    packed = pack_tf32_operand(feat, scale)
    assert torch.equal(packed, pack_tf32_operand_plain(feat, scale))
    rows_pad, cp = -(-rows // 64) * 64, -(-c // 32) * 32
    assert tuple(packed.shape) == tf32_packed_shape(2, rows, c) == (2, rows_pad // 64, cp // 32, 8, 8, 8, 4)
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    words = packed.numpy()
    np.testing.assert_array_equal(_numpy_unpack_tf32(words, rows, c), (feat * scale).numpy())
    assert np.count_nonzero(words) == np.count_nonzero((feat * scale).numpy())
    full = _numpy_unpack_tf32(words, rows_pad, cp)
    assert not full[:, rows:].any() and not full[:, :, c:].any()


@pytest.mark.parametrize("c", [600, 640, 1000])
@pytest.mark.parametrize("rows", [7, 130])
def test_pack_tf32_operand_at_the_wide_instances_padding(c, rows):
    """The wide split-TF32 instance of K2 reads f0 in the same layout with the
    channels padded to 64 (an even count of 32-channel chunks, as
    wgmma_gemm.cuh's split-TF32 loop takes them), at any width."""
    rng = np.random.default_rng(c + rows)
    feat = torch.from_numpy(rng.standard_normal((2, rows, c)).astype(np.float32))
    scale = 1.0 / c ** 0.5
    packed = pack_tf32_operand(feat, scale, 64)
    rows_pad, cp = -(-rows // 64) * 64, -(-c // 64) * 64
    assert tuple(packed.shape) == tf32_packed_shape(2, rows, c, 64) == (2, rows_pad // 64, cp // 32, 8, 8, 8, 4)
    words = packed.numpy()
    np.testing.assert_array_equal(_numpy_unpack_tf32(words, rows, c), (feat * scale).numpy())
    assert np.count_nonzero(words) == np.count_nonzero((feat * scale).numpy())
    full = _numpy_unpack_tf32(words, rows_pad, cp)
    assert not full[:, rows:].any() and not full[:, :, c:].any()


@pytest.mark.parametrize("c", [600, 640, 1000])
@pytest.mark.parametrize("rows", [7, 130, 300])
def test_pack_tf32_hilo_matches_the_byte_formula(c, rows):
    """The wide split-TF32 instance's f1: for each 128-row tile and 32-channel
    chunk, the TF32 hi image and then the lo image (kernels.tf32_split of the
    scaled value), element (r, k) of each at in_chunk32(r % 128, k % 32): byte
    (r // 128) * 1024 Cp + (k // 32) * 32768 + half * 16384 + ((r % 128) // 8)
    * 1024 + ((k % 32) // 4) * 128 + (r % 8) * 16 + (k % 4) * 4, channels padded
    to 64 and rows to 128, zeros elsewhere."""
    rng = np.random.default_rng(c + rows)
    feat = torch.from_numpy(rng.standard_normal((2, rows, c)).astype(np.float32))
    scale = 1.0 / c ** 0.5
    packed = pack_tf32_hilo(feat, scale)
    rows_pad, cp = -(-rows // 128) * 128, -(-c // 64) * 64
    assert tuple(packed.shape) == tf32_hilo_packed_shape(2, rows, c) == (2, rows_pad // 128, cp // 32, 2, 16, 8, 8, 4)
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    flat = packed.numpy().reshape(2, -1)

    def unpack(half, n_rows, n_c):
        r = np.arange(n_rows)[:, None]
        k = np.arange(n_c)[None, :]
        byte = ((r // 128) * 1024 * cp + (k // 32) * 32768 + half * 16384 + ((r % 128) // 8) * 1024
                + ((k % 32) // 4) * 128 + (r % 8) * 16 + (k % 4) * 4)
        return flat[:, byte // 4]

    hi, lo = tf32_split(feat * scale)
    np.testing.assert_array_equal(unpack(0, rows, c), hi.numpy())
    np.testing.assert_array_equal(unpack(1, rows, c), lo.numpy())
    assert np.count_nonzero(flat) == np.count_nonzero(hi.numpy()) + np.count_nonzero(lo.numpy())
    for half in (0, 1):
        full = unpack(half, rows_pad, cp)
        assert not full[:, rows:].any() and not full[:, :, c:].any()


@pytest.mark.parametrize("n,k", [(256, 256), (256, 512), (8, 16)])
def test_pack_weight_chunks_tf32_layout(n, k):
    """K1's split-TF32 weight chunks: per 8 input columns, the hi and then the
    lo image [N, 8] in the K-major layout of 4-byte values; hi + lo is the weight."""
    rng = np.random.default_rng(n + k)
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32))
    chunks = pack_weight_chunks_tf32(w)
    assert chunks.shape == (k // 8, 2, n // 8, 2, 8, 4) and chunks.is_contiguous()
    flat = chunks.reshape(k // 8, 2, -1)
    hi, lo = tf32_split(w)
    for row, col in ((0, 0), (n - 1, k - 1), (n // 2 + 3, k // 2 + 5), (7, 3), (n - 8, 6 % k)):
        kk = col % 8
        word = ((row // 8) * 256 + (kk // 4) * 128 + (row % 8) * 16 + (kk % 4) * 4) // 4
        assert flat[col // 8, 0, word] == hi[row, col] and flat[col // 8, 1, word] == lo[row, col]
    unpacked = chunks.permute(1, 2, 4, 0, 3, 5).reshape(2, n, k)  # [half, ng, nr, chunk, kg, kc]
    assert torch.equal(unpacked[0], hi) and torch.equal(unpacked[1], lo)
    with pytest.raises(ValueError):
        pack_weight_chunks_tf32(torch.zeros(12, 8))


def _k2_errors(stats, ref):
    lse = max((stats[k] - ref[k]).abs().max().item()
              for k in ("row_lse", "col_lse", "row_best_val", "col_best_val"))
    agree = min((stats[k] == ref[k]).float().mean().item() for k in ("row_best_j", "col_best_p"))
    return lse, agree


def test_three_tf32_products_hold_k2_to_the_f32_tolerances_and_one_does_not():
    """K2's statistics at its magnitudes (features ~N(0, 1) scaled by 1/sqrt(C),
    inv_temp 1/0.0801, C = 256: logits of std ~12) from the split product,
    emulated as one f32 product over the concatenated halves
    [lo0, hi0, hi0] . [hi1, lo1, hi1], stay within the tolerances the f32
    instance is held to on the card (LSE and best values 1e-3, argmaxes
    99.9 %): measured ~6e-6. One TF32 product (hi0 . hi1) misses the LSE
    tolerance (~1.6e-3 here)."""
    rng = np.random.default_rng(0)
    inv_temp = 1.0 / 0.0801
    f0 = torch.from_numpy(rng.standard_normal((2, 333, 256)).astype(np.float32)) / 16.0
    f1 = torch.from_numpy(rng.standard_normal((2, 200, 256)).astype(np.float32)) / 16.0
    ref = rowcol_stats_plain(f0, f1, inv_temp)
    (h0, l0), (h1, l1) = tf32_split(f0), tf32_split(f1)
    three = rowcol_stats_plain(torch.cat([l0, h0, h0], -1), torch.cat([h1, l1, h1], -1), inv_temp)
    one = rowcol_stats_plain(h0, h1, inv_temp)
    lse3, agree3 = _k2_errors(three, ref)
    lse1, _ = _k2_errors(one, ref)
    print(f"split TF32: LSE max|d| {lse3:.3e}, argmax agreement {agree3:.4f}; one TF32 product: "
          f"LSE max|d| {lse1:.3e}")
    assert lse3 < 1e-3 and agree3 >= 0.999
    assert lse1 >= 1e-3


def _stats64(sim, inv_temp):
    """K2's statistics of a similarity in float64: the LSEs and best values."""
    s = sim.double() * inv_temp
    row_lse, col_lse = torch.logsumexp(s, 2), torch.logsumexp(s, 1)
    return {"row_lse": row_lse, "col_lse": col_lse,
            "row_best_val": (2 * s - col_lse[:, None, :]).max(2).values,
            "col_best_val": (2 * s - row_lse[:, :, None]).max(1).values}


def test_wide_split_tf32_in_pairs_of_chunks_holds_k2_at_2048_channels():
    """The wide split-TF32 instance's arithmetic at C = 2048 (csrc/wgmma_gemm.cuh,
    Ring32): each 32-channel chunk split as the kernels split it, the three
    products of a pair of chunks (64 channels) summed in a fresh accumulator
    (emulated as one f32 product over the concatenated halves), the pairs added
    into an f32 sum in order. Its LSEs and best values stay within the 1e-3 the
    card holds K2's f32 instances to, measured from float64 (~2e-6 here), and
    its mean row-LSE distance to float64 within 2x plain f32's; one TF32
    product misses 1e-3 (~2e-3). Features of norm 2 (logits of std ~25, a
    confident matcher's), inv_temp 1/0.0801."""
    rng = np.random.default_rng(0)
    c, inv_temp = 2048, 1.0 / 0.0801
    f0 = torch.from_numpy(rng.standard_normal((2, 333, c)).astype(np.float32)) * (2 / c ** 0.5)
    f1 = torch.from_numpy(rng.standard_normal((2, 200, c)).astype(np.float32)) * (2 / c ** 0.5)
    t1 = lambda x: x.transpose(1, 2)  # noqa: E731
    ref = _stats64(f0.double() @ t1(f1.double()), inv_temp)
    pairs = torch.zeros(2, 333, 200)
    for k0 in range(0, c, 64):
        (h0, l0), (h1, l1) = tf32_split(f0[..., k0:k0 + 64]), tf32_split(f1[..., k0:k0 + 64])
        pairs = pairs + torch.cat([l0, h0, h0], -1) @ t1(torch.cat([h1, l1, h1], -1))
    runs = {"pairs": pairs, "single": tf32_round(f0) @ t1(tf32_round(f1)), "f32": f0 @ t1(f1)}
    err, mean = {}, {}
    for name, sim in runs.items():
        got = _stats64(sim, inv_temp)
        err[name] = max((got[k] - ref[k]).abs().max().item() for k in ref)
        mean[name] = (got["row_lse"] - ref["row_lse"]).abs().mean().item()
    print(f"max|d| from float64 {err}, mean row-LSE distance {mean}")
    assert err["pairs"] < 1e-3 and err["single"] >= 1e-3
    assert mean["pairs"] <= 2 * mean["f32"]
