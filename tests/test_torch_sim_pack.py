"""The operand packs of the tensor-core instances of K2 and K5 (``ops/cuda_matching.py::
pack_operand``, and ``pack_wide_operand`` above 576 channels), which run without a
GPU: their plain versions against a numpy rendering of the byte formulas of
``csrc/wgmma.cuh``'s unswizzled K-major layout (``pack_operand``: channels padded to
a multiple of 16, rows to 64, a block's tile) and of ``csrc/wgmma_gemm.cuh``'s
``in_chunk`` (``pack_wide_operand``: [tile][64-channel chunk] images), and K2's
routing by width and operand type (``k2_instance``).
"""
import numpy as np
import pytest
import torch

from onepose_plus_plus_tpu_torch import kernels
from onepose_plus_plus_tpu_torch.ops.cuda_matching import (
    k2_instance,
    pack_operand,
    pack_operand_plain,
    pack_wide_operand,
    packed_shape,
    wide_packed_shape,
)

torch.set_num_threads(2)


def _numpy_unpack(packed: np.ndarray, rows: int, c: int) -> np.ndarray:
    """Element (r, k) of batch element b read at byte
    (r // 8) * 16 Cp + (k // 8) * 128 + (r % 8) * 16 + (k % 8) * 2 of its slab."""
    b = packed.shape[0]
    cp = packed.shape[2] * 8
    flat = packed.reshape(b, -1)  # uint16 words: byte offset / 2
    r = np.arange(rows)[:, None]
    k = np.arange(c)[None, :]
    word = ((r // 8) * 16 * cp + (k // 8) * 128 + (r % 8) * 16 + (k % 8) * 2) // 2
    return flat[:, word]


@pytest.mark.parametrize("c", [32, 64, 96, 256])
@pytest.mark.parametrize("rows", [7, 130])  # P not a multiple of a tile
def test_pack_operand_matches_the_byte_formula(c, rows):
    rng = np.random.default_rng(c + rows)
    feat = torch.from_numpy(rng.standard_normal((2, rows, c)).astype(np.float32))
    scale = 1.0 / c ** 0.5
    kernels.reset_launch_counts()
    packed = pack_operand(feat, scale)
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    rows_pad, cp = -(-rows // 64) * 64, -(-c // 16) * 16
    assert tuple(packed.shape) == packed_shape(2, rows, c) == (2, rows_pad // 8, cp // 8, 8, 8)
    words = packed.view(torch.int16).numpy().view(np.uint16)
    got = _numpy_unpack(words, rows, c)
    want = (feat * scale).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)  # bit for bit: the scaled bf16 operand
    # everything else is zero padding: as many non-zero words as the operand has
    assert np.count_nonzero(words) == np.count_nonzero(want)
    full = _numpy_unpack(words, rows_pad, cp)
    assert not full[:, rows:].any() and not full[:, :, c:].any()


def test_pack_operand_of_bf16_features_is_a_layout_change():
    """K5 packs operands that are already scaled and rounded: unscaled, the
    pack only moves bits."""
    rng = np.random.default_rng(0)
    feat = torch.from_numpy(rng.standard_normal((1, 70, 48)).astype(np.float32)).to(torch.bfloat16)
    packed = pack_operand_plain(feat)
    b, rg, kg = packed.shape[:3]
    unpacked = packed.permute(0, 1, 3, 2, 4).reshape(b, rg * 8, kg * 8)
    assert torch.equal(unpacked[:, :70, :48], feat)
    assert not unpacked[:, 70:].any() and not unpacked[:, :, 48:].any()


def _in_chunk(r, k):
    """Byte of element (r, k) of a [rows, 64] bf16 chunk image (wgmma_gemm.cuh: in_chunk)."""
    return (r // 8) * 1024 + (k // 8) * 128 + (r % 8) * 16 + (k % 8) * 2


@pytest.mark.parametrize("tile_rows", [64, 128])
@pytest.mark.parametrize("c", [600, 640, 1000])  # C padded to 64 where not a multiple of it
@pytest.mark.parametrize("rows", [7, 130])
def test_pack_wide_operand_matches_the_byte_formula(c, rows, tile_rows):
    """The wide bf16 instance of K2 reads f0 in 64-row and f1 in 128-row tiles,
    each [tile][64-channel chunk] image contiguous: element (r, k) at byte
    (r // TR) * 2 TR Cp + (k // 64) * 128 TR + in_chunk(r % TR, k % 64); the
    plain pack matches that bit for bit, and everything else is zero padding."""
    rng = np.random.default_rng(c + rows + tile_rows)
    feat = torch.from_numpy(rng.standard_normal((2, rows, c)).astype(np.float32))
    scale = 1.0 / c ** 0.5
    kernels.reset_launch_counts()
    packed = pack_wide_operand(feat, scale, tile_rows)
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}
    rows_pad, cp = -(-rows // tile_rows) * tile_rows, -(-c // 64) * 64
    assert tuple(packed.shape) == wide_packed_shape(2, rows, c, tile_rows)
    assert tuple(packed.shape) == (2, rows_pad // tile_rows, cp // 64, tile_rows // 8, 8, 8, 8)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    words = packed.view(torch.int16).numpy().view(np.uint16).reshape(2, -1)

    def unpack(n_rows, n_c):
        r = np.arange(n_rows)[:, None]
        k = np.arange(n_c)[None, :]
        byte = ((r // tile_rows) * 2 * tile_rows * cp + (k // 64) * 128 * tile_rows
                + _in_chunk(r % tile_rows, k % 64))
        return words[:, byte // 2]

    want = (feat * scale).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(unpack(rows, c), want)
    assert np.count_nonzero(words) == np.count_nonzero(want)
    full = unpack(rows_pad, cp)
    assert not full[:, rows:].any() and not full[:, :, c:].any()


def test_pack_wide_operand_of_bf16_values_is_a_layout_change():
    """K5's wide instance packs its already rounded bf16 operands for K2's wide
    LSE pass unscaled: the same values, moved."""
    rng = np.random.default_rng(1)
    feat = torch.from_numpy(rng.standard_normal((1, 70, 650)).astype(np.float32)).to(torch.bfloat16)
    packed = pack_wide_operand(feat, 1.0, 64)
    b, tiles, chunks = packed.shape[:3]
    unpacked = packed.permute(0, 1, 3, 5, 2, 4, 6).reshape(b, tiles * 64, chunks * 64)
    assert torch.equal(unpacked[:, :70, :650], feat)
    assert not unpacked[:, 70:].any() and not unpacked[:, :, 650:].any()


@pytest.mark.parametrize("c,bf16,f32", [
    (32, "tc", "tf32x3"), (256, "tc", "tf32x3"), (576, "tc", "tf32x3"), (577, "wide_bf16", "wide_tf32"),
    (640, "wide_bf16", "wide_tf32"), (1000, "wide_bf16", "wide_tf32"), (4096, "wide_bf16", "wide_tf32"),
    (8192, "wide_bf16", "wide_tf32"),
])
def test_k2_instance_routes_by_width_and_operand_type(c, bf16, f32):
    """The resident-tile instances up to 576 channels, the channel-streaming
    ones above at any width (no CUDA-core instance is left)."""
    assert k2_instance(c, torch.bfloat16) == bf16
    assert k2_instance(c, torch.float32) == f32


def test_k2_instance_refuses_what_no_instance_takes():
    with pytest.raises(ValueError):
        k2_instance(0, torch.float32)
    with pytest.raises(ValueError):
        k2_instance(256, torch.float16)
