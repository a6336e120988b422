"""Operations and bytes of the work the cells run, from shapes alone, and the
chip's peaks (the yardstick of every roofline and ``mfu`` reading).

Peaks are NVIDIA's published dense rates for one H100 SXM at its 700 W limit.
A kernel's bound is the larger of its bytes over the memory rate and its
operations over the peak of its operand type; each input byte is counted read
once and each output byte written once, whatever a kernel reads again. Model
FLOPs count the matrix products (convolutions, projections, attention
products, similarities) of the forward; a training step adds two times the
forward for the backward.
"""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple

PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(n_bytes: float, ops: float, precision: str) -> float:
    """Least seconds of a piece of work on one H100."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[precision])


def conv_flops(cin: int, cout: int, k: int, h_out: int, w_out: int) -> float:
    return 2.0 * cin * cout * k * k * h_out * w_out


def backbone_flops(h: int, w: int, initial_dim: int = 128, block_dims: Sequence[int] = (128, 196, 256)) -> float:
    """ResNet-FPN 8/2 on one [h, w] grey image: the stem (7x7/2), two
    BasicBlocks a stage at 1/2, 1/4 and 1/8 (downsample 1x1 where strided) and
    the FPN's 1x1 laterals and 3x3 pairs back to 1/2."""
    d0, d1, d2 = block_dims
    h2, w2, h4, w4, h8, w8 = h // 2, w // 2, h // 4, w // 4, h // 8, w // 8
    f = conv_flops(1, initial_dim, 7, h2, w2)

    def stage(cin, cout, hh, ww, strided):
        s = conv_flops(cin, cout, 3, hh, ww) + 3 * conv_flops(cout, cout, 3, hh, ww)
        return s + (conv_flops(cin, cout, 1, hh, ww) if strided else 0.0)

    f += stage(initial_dim, d0, h2, w2, False) + stage(d0, d1, h4, w4, True) + stage(d1, d2, h8, w8, True)
    f += conv_flops(d2, d2, 1, h8, w8)  # layer3_outconv
    f += conv_flops(d1, d2, 1, h4, w4) + conv_flops(d2, d2, 3, h4, w4) + conv_flops(d2, d1, 3, h4, w4)
    f += conv_flops(d0, d1, 1, h2, w2) + conv_flops(d1, d1, 3, h2, w2) + conv_flops(d1, d0, 3, h2, w2)
    return f


def encoder_layer_ops(l: int, s: int, c: int, nhead: int) -> float:
    """One linear-attention LoFTR layer, x [l, c] attending to source [s, c]: the
    q, k, v, merge projections and the FFN on [x | msg] (16 l c^2 + 4 s c^2) and
    K'^T [V | 1] and the attention products (2 (l + s) c (c / nhead + 1))."""
    return 16.0 * l * c * c + 4.0 * s * c * c + 2.0 * (l + s) * c * (c // nhead + 1)


def encoder_layer_bytes(n: int, l: int, s: int, c: int, weight_bytes: int) -> float:
    """One K1 launch over n sequences: x and source in, y out (float32), the
    packed weights and LayerNorm parameters once."""
    return 4.0 * n * (2 * l + s) * c + 10.0 * c * c * weight_bytes + 16.0 * c


def two_stream_ops(len0: int, len1: int, c: int, nhead: int, names: Iterable[str]) -> float:
    """A LoFTR feature transformer on streams of len0 and len1 tokens: each
    'self' layer runs each stream on itself, each 'cross' layer each on the other."""
    ops = 0.0
    for name in names:
        if name == "self":
            ops += encoder_layer_ops(len0, len0, c, nhead) + encoder_layer_ops(len1, len1, c, nhead)
        else:
            ops += encoder_layer_ops(len0, len1, c, nhead) + encoder_layer_ops(len1, len0, c, nhead)
    return ops


def keypoint_encoder_flops(n_points: int, widths: Sequence[int]) -> float:
    dims = [3, *widths]
    return sum(2.0 * n_points * a * b for a, b in zip(dims[:-1], dims[1:]))


def similarity_flops(p: int, l: int, c: int) -> float:
    """One [p, c] x [c, l] similarity product."""
    return 2.0 * p * l * c


def onepose_frame_flops(img: int, n_points: int, slots: int, model: dict) -> float:
    """Forward matrix FLOPs of the 2D-3D matcher for one frame."""
    bb, co, fi = model["loftr_backbone"], model["loftr_coarse"], model["loftr_fine"]
    kp = model["keypoints_encoding"]
    grid = (img // 8) ** 2
    c, cf, w = co["d_model"], fi["d_model"], fi["window_size"]
    flops = backbone_flops(img, img, bb["initial_dim"], bb["block_dims"])
    flops += keypoint_encoder_flops(n_points, [*kp["keypoints_encoder"], kp["descriptor_dim"]])
    flops += two_stream_ops(n_points, grid, c, co["nhead"], list(co["layer_names"]) * co["layer_iter_n"])
    flops += similarity_flops(n_points, grid, c)
    fine = two_stream_ops(1, w * w, cf, fi["nhead"], list(fi["layer_names"]) * fi["layer_iter_n"])
    return flops + slots * (fine + 2.0 * w * w * cf)


def loftr_coarse_pair_flops(img: int, model: dict) -> Tuple[float, float]:
    """(backbone of both images, coarse transformer) FLOPs of one image pair."""
    grid = (img // 8) ** 2
    c = model["d_model"]
    return 2 * backbone_flops(img, img), two_stream_ops(grid, grid, c, model["nhead"],
                                                       ["self", "cross"] * model["layer_iter_n"])


def loftr_match_coarse_flops(img: int, model: dict) -> float:
    """``match_coarse`` of one pair: both backbones, the coarse transformer, the similarity."""
    grid = (img // 8) ** 2
    return sum(loftr_coarse_pair_flops(img, model)) + similarity_flops(grid, grid, model["d_model"])


def loftr_refine_flops(img: int, slots: int, model: dict) -> float:
    """``refine`` of one pair: both backbones and the coarse transformer (the
    surface samples its features), the fine transformer on every slot's two
    W x W windows and the centre's correlation with the window."""
    w = model["fine_window_size"]
    fine = two_stream_ops(w * w, w * w, 128, 8, ["self", "cross"])
    return sum(loftr_coarse_pair_flops(img, model)) + slots * (fine + 2.0 * w * w * 128)


def k2_work(n: int, p: int, l: int, c: int) -> Tuple[float, float]:
    """(bytes, ops) of one K2 call, its operand pack included: float32 features
    in, a row's and a column's statistics out; one similarity product."""
    return 4.0 * n * (p + l) * c + 16.0 * n * (p + l), n * similarity_flops(p, l, c)


def k5_work(n: int, p: int, l: int, c: int) -> Tuple[float, float]:
    """(bytes, ops) of K5's forward and backward together, its operand pack and
    LSE pass included: the float32 features in and their gradients out, GT
    cells in; the least products, one similarity forward and the two gradient
    products."""
    return 8.0 * n * (p + l) * c + 4.0 * n * p, 3 * n * similarity_flops(p, l, c)
