"""Soft-argmax over correlation heatmaps (port of
``onepose_plus_plus_tpu/ops/soft_argmax.py``; kornia ``dsnt`` conventions:
x = linspace(-1, 1, W) along columns, x varying fastest)."""
from __future__ import annotations

import torch


def _normalized_grid(window: int, device, dtype) -> torch.Tensor:
    """[W*W, 2] grid of (x, y) in [-1, 1]."""
    if window > 1:
        lin = torch.linspace(-1.0, 1.0, window, device=device, dtype=dtype)
    else:
        lin = torch.zeros(1, device=device, dtype=dtype)
    ys, xs = torch.meshgrid(lin, lin, indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)


def spatial_expectation_2d(heatmap: torch.Tensor, window: int) -> torch.Tensor:
    """Expected (x, y) in [-1, 1] of heatmaps [..., W*W] -> [..., 2]."""
    return heatmap @ _normalized_grid(window, heatmap.device, heatmap.dtype)


def heatmap_std(heatmap: torch.Tensor, coords: torch.Tensor, window: int) -> torch.Tensor:
    """Sum over x and y of sqrt(clamp(E[g^2] - E[g]^2, 1e-10)) -> [...]."""
    grid = _normalized_grid(window, heatmap.device, heatmap.dtype)
    var = heatmap @ (grid * grid) - coords * coords
    return torch.sqrt(var.clamp_min(1e-10)).sum(dim=-1)
