"""The dynamically quantized int8 convolution of the backbone (inference only).

Port of ``onepose_plus_plus_tpu/models/backbone.py::_quant_conv`` (:109-140):
weights quantized per output channel, ``sw = max(max|w| / 127, 1e-12)``;
activations with one scale for the whole batch tensor, ``sx = max(max|x| /
127, 1e-12)`` (so a frame's result depends on its batch, as in the JAX
package); both rounded half to even after a true division and clipped to
±127; the product int8 x int8 accumulated exactly in int32; the output
``(acc.float() * (sx * sw)).to(x.dtype)``.

The JAX package computes the integer product with ``lax.conv_general_dilated``
outside any Pallas kernel. PyTorch has no int8 convolution, so the port
unfolds the padded int8 map (im2col, frames in chunks) and multiplies by
``torch._int_mm`` (cuBLASLt on the card, int32 accumulation; exact). The
reduction and output widths are zero-padded to multiples of 8 and the rows to
more than 16, as ``_int_mm`` requires on the card; the zeros add nothing. An
f32 convolution over the integer values would not do: its sums pass 2^24,
and cuDNN may pick TF32 or Winograd.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

CHUNK_BYTES = 1 << 28  # the unfolded int8 rows of one _int_mm call, at most (but one frame)


def _over_127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as a true division: PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal (one ulp off on some values), so the divisor
    is a tensor on t's device."""
    return t / t.new_full((), 127.0)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 OIHW weight -> (int8 weight, f32 scale [O])."""
    sw = _over_127(w.abs().amax(dim=(1, 2, 3))).clamp_min(1e-12)
    return torch.round(w / sw[:, None, None, None]).clamp(-127, 127).to(torch.int8), sw


def quantize_activation(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (any float dtype) -> (int8 x, f32 scalar scale of the whole tensor)."""
    sx = _over_127(x.abs().amax().float()).clamp_min(1e-12)
    return torch.round(x.float() / sx).clamp(-127, 127).to(torch.int8), sx


def _ceil8(v: int) -> int:
    return -(-v // 8) * 8


def int8_conv_accumulate(xq: torch.Tensor, wq: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """The exact int32 sums of an int8 convolution: xq [N, C, H, W], wq [O, C,
    kh, kw] -> [N, O, Ho, Wo] int32 (channels_last memory)."""
    n, c, h, w = xq.shape
    o, _, kh, kw = wq.shape
    taps = c * kh * kw
    kp, op = _ceil8(taps), _ceil8(o)
    wmat = wq.new_zeros(op, kp)
    wmat[:o, :taps] = wq.reshape(o, taps)
    nhwc = F.pad(xq, (padding,) * 4).permute(0, 2, 3, 1)
    patches = nhwc.unfold(1, kh, stride).unfold(2, kw, stride)  # [N, Ho, Wo, C, kh, kw] view
    ho, wo = patches.shape[1:3]
    per_frame = ho * wo * kp
    frames = max(1, CHUNK_BYTES // per_frame)
    out = torch.empty((n, ho, wo, o), dtype=torch.int32, device=xq.device)
    for f0 in range(0, n, frames):
        f1 = min(n, f0 + frames)
        rows = (f1 - f0) * ho * wo
        a = xq.new_empty((max(rows, 17), kp))
        a[:, taps:] = 0
        a[rows:] = 0
        a[:rows].view(f1 - f0, ho, wo, kp)[..., :taps].unflatten(-1, (c, kh, kw)).copy_(patches[f0:f1])
        acc = torch._int_mm(a, wmat.t())
        out[f0:f1] = acc[:rows, :o].view(f1 - f0, ho, wo, o)
    return out.permute(0, 3, 1, 2)


def quant_conv(x: torch.Tensor, weight: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """Dynamically quantized conv of x [N, C, H, W] by the f32 weight [O, C,
    kh, kw]; output in x's dtype."""
    wq, sw = quantize_weight(weight)
    xq, sx = quantize_activation(x)
    acc = int8_conv_accumulate(xq, wq, stride, padding)
    return (acc.float() * (sx * sw)[:, None, None]).to(x.dtype)
