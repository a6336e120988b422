"""Positional encodings (port of ``onepose_plus_plus_tpu/models/position_encoding.py``;
reference ``utils/position_encoding.py``).

- ``sine_position_encoding``: the 2D sine PE, including the LoFTR "temp bug"
  (``-log(1e4) / d_model // 2``, a floor division that collapses to -1.0) the
  released weights were trained with.
- ``normalize_3d_keypoints``: tight-box normalisation; the extent comes from
  batch element 0 (reference quirk, ``normalize.py:20``).
- ``KeypointEncoder``: the MLP over xyz, normalised between its Linear layers
  by torch ``InstanceNorm1d`` applied to [B, L, C] (which normalises each
  keypoint over its channels; the default), a ``LayerNorm`` or nothing.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..parallel.comm import batch_first_shard


@functools.lru_cache(maxsize=8)
def _sine_pe_table(d_model: int, h: int, w: int, temp_bug_fix: bool) -> np.ndarray:
    """[h, w, d_model] float32 table; positions are 1-indexed."""
    pe = np.zeros((d_model, h, w), dtype=np.float32)
    y_pos = np.arange(1, h + 1, dtype=np.float32)[None, :, None] * np.ones((1, 1, w), np.float32)
    x_pos = np.arange(1, w + 1, dtype=np.float32)[None, None, :] * np.ones((1, h, 1), np.float32)
    if temp_bug_fix:
        exponent = -math.log(10000.0) / (d_model // 2)
    else:
        exponent = (-math.log(10000.0) / d_model) // 2
    div_term = np.exp(np.arange(0, d_model // 2, 2, dtype=np.float32) * exponent)[:, None, None]
    pe[0::4] = np.sin(x_pos * div_term)
    pe[1::4] = np.cos(x_pos * div_term)
    pe[2::4] = np.sin(y_pos * div_term)
    pe[3::4] = np.cos(y_pos * div_term)
    return np.transpose(pe, (1, 2, 0))


def sine_position_encoding(x: torch.Tensor, temp_bug_fix: bool = False) -> torch.Tensor:
    """Add the 2D sine PE to an NHWC feature map (in x's dtype)."""
    _, h, w, c = x.shape
    pe = torch.from_numpy(_sine_pe_table(c, h, w, temp_bug_fix)).to(x.device, x.dtype)
    return x + pe[None]


def normalize_3d_keypoints(kpts: torch.Tensor) -> torch.Tensor:
    """[N, L, 3] -> (kpts - per-sample mean) / (0.6 * max extent of sample 0)
    (of the global batch's sample 0 in data-parallel training)."""
    extent = batch_first_shard(kpts[0].amax(dim=0) - kpts[0].amin(dim=0))
    center = kpts.mean(dim=-2, keepdim=True)
    return (kpts - center) / (extent.max() * 0.6)


class _QuirkInstanceNorm(nn.Module):
    """torch InstanceNorm1d on [B, L, C]: normalises over the last axis (eps 1e-5)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + 1e-5)


def _norm(method: str, width: int) -> nn.Module:
    if method == "instancenorm":
        return _QuirkInstanceNorm()
    if method == "layernorm":
        return nn.LayerNorm(width, eps=1e-5)
    if method == "none":
        return nn.Identity()
    raise ValueError(method)


class KeypointEncoder(nn.Module):
    """MLP encoding of normalised 3D keypoints added to the descriptors.

    ``encoder`` holds Linear layers at indices 0, 3, 6, 9, as the reference
    ``KeypointEncoding_linear`` does, in every ``norm_method``: the norm
    (``instancenorm``, ``layernorm`` with flax's eps 1e-5, scale and bias) or
    an ``nn.Identity`` (``none``) sits at 1, 4, 7.
    """

    def __init__(self, layers: Sequence[int] = (32, 64, 128), feature_dim: int = 256,
                 norm_method: str = "instancenorm"):
        super().__init__()
        widths = [3, *layers, feature_dim]
        mods = []
        for i in range(len(widths) - 1):
            mods.append(nn.Linear(widths[i], widths[i + 1]))
            if i < len(widths) - 2:
                mods += [_norm(norm_method, widths[i + 1]), nn.ReLU()]
        self.encoder = nn.Sequential(*mods)

    def forward(self, kpts: torch.Tensor, descriptors: torch.Tensor) -> torch.Tensor:
        """kpts [N, L, 3] (normalised), descriptors [N, L, C] -> [N, L, C]."""
        return descriptors + self.encoder(kpts.float())
