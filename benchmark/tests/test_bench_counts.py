"""The operation and byte counts against shapes worked by hand."""
from __future__ import annotations

import pytest

from benchmark import counts


def test_backbone_flops_at_512():
    # stem 7x7/2: 1 -> 128 at 256^2; layer1 4 convs 128 -> 128 at 256^2; layer2 at 128^2:
    # 128 -> 196, 3 x 196 -> 196, 1x1 128 -> 196; layer3 at 64^2 likewise to 256; the FPN:
    # 1x1 256 -> 256 at 64^2, at 128^2 1x1 196 -> 256 and 3x3 256 -> 256 -> 196, at 256^2
    # 1x1 128 -> 196 and 3x3 196 -> 196 -> 128
    mac = (49 * 128 * 256 ** 2 + 4 * 9 * 128 * 128 * 256 ** 2
           + (9 * 128 * 196 + 3 * 9 * 196 * 196 + 128 * 196) * 128 ** 2
           + (9 * 196 * 256 + 3 * 9 * 256 * 256 + 196 * 256) * 64 ** 2
           + 256 * 256 * 64 ** 2 + (196 * 256 + 9 * 256 * 256 + 9 * 256 * 196) * 128 ** 2
           + (128 * 196 + 9 * 196 * 196 + 9 * 196 * 128) * 256 ** 2)
    assert counts.backbone_flops(512, 512) == pytest.approx(2 * mac, rel=1e-12)
    assert counts.backbone_flops(512, 512) == pytest.approx(253.452877824e9, rel=1e-9)


def test_encoder_layer_ops_and_bytes():
    # x [3, 8] attends to source [5, 8], 2 heads of 4: q and merge 2 x 3 x 8 x 8 each, k and v
    # 2 x 5 x 8 x 8 each, the FFN [3, 16] x [16, 16] and [3, 16] x [16, 8]; K'^T [V | 1] 2 x 5 x 8 x 5,
    # the attention product and its normaliser 2 x 3 x 8 x 5
    l, s, c = 3, 5, 8
    by_hand = 2 * (2 * l * c * c + 2 * s * c * c + l * 2 * c * 2 * c + l * 2 * c * c) + 2 * (l + s) * c * 5
    assert counts.encoder_layer_ops(l, s, c, 2) == by_hand
    assert counts.encoder_layer_bytes(2, l, s, c, 2) == 4 * 2 * (2 * l + s) * c + 10 * c * c * 2 + 16 * c


def test_two_stream_and_frame_flops():
    ops = counts.two_stream_ops(7, 11, 8, 2, ["self", "cross"])
    e = counts.encoder_layer_ops
    assert ops == e(7, 7, 8, 2) + e(11, 11, 8, 2) + e(7, 11, 8, 2) + e(11, 7, 8, 2)
    model = {"loftr_backbone": {"initial_dim": 8, "block_dims": [8, 12, 16]},
             "keypoints_encoding": {"keypoints_encoder": [4], "descriptor_dim": 16},
             "loftr_coarse": {"d_model": 16, "nhead": 2, "layer_names": ["self", "cross"], "layer_iter_n": 1},
             "loftr_fine": {"d_model": 8, "nhead": 2, "layer_names": ["self", "cross"], "layer_iter_n": 1,
                            "window_size": 3}}
    grid = (64 // 8) ** 2
    want = (counts.backbone_flops(64, 64, 8, [8, 12, 16]) + 2 * 10 * (3 * 4 + 4 * 16)
            + counts.two_stream_ops(10, grid, 16, 2, ["self", "cross"]) + 2 * 10 * grid * 16
            + 5 * (counts.two_stream_ops(1, 9, 8, 2, ["self", "cross"]) + 2 * 9 * 8))
    assert counts.onepose_frame_flops(64, 10, 5, model) == pytest.approx(want, rel=1e-12)


def test_kernel_work_and_bounds():
    n_bytes, ops = counts.k2_work(2, 7, 5, 4)
    assert n_bytes == 4 * 2 * 12 * 4 + 16 * 2 * 12 and ops == 2 * 2 * 7 * 5 * 4
    n_bytes, ops = counts.k5_work(2, 7, 5, 4)
    assert n_bytes == 8 * 2 * 12 * 4 + 4 * 2 * 7 and ops == 3 * 2 * 2 * 7 * 5 * 4
    assert counts.bound_s(3.35e12, 1.0, "bf16") == pytest.approx(1.0)
    assert counts.bound_s(1.0, 989e12, "bf16") == pytest.approx(1.0)
    assert counts.bound_s(1.0, 495e12, "tf32") == pytest.approx(1.0)
