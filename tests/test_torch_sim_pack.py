"""The operand pack of the tensor-core instances of K2 and K5 (``ops/cuda_matching.py::
pack_operand``), which runs without a GPU: its plain version against a numpy
rendering of the byte formula of ``csrc/wgmma.cuh``'s unswizzled K-major layout,
with channels padded to a multiple of 16 and rows to a multiple of 64 (a
block's tile).
"""
import numpy as np
import pytest
import torch

from onepose_plus_plus_tpu_torch import kernels
from onepose_plus_plus_tpu_torch.ops.cuda_matching import (
    pack_operand,
    pack_operand_plain,
    packed_shape,
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
