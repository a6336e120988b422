"""Fine-window gathering (port of ``onepose_plus_plus_tpu/ops/window_gather.py``).

Instead of unfolding every W x W window of the fine map (reference
``fine_preprocess.py:41-54``), only the K matched windows are gathered. Both
matchers centre each window on a coarse cell (``center = stride * cell``) in
:func:`gather_windows_aligned`: kernel K3, its gradient in feat kernel K4
(``ops/cuda_gather.py``). The SfM refine path centres windows on arbitrary
integer pixels (:func:`gather_windows`): kernel K6
(``ops/cuda_patch_gather.py``), which has no gradient.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .cuda_gather import WindowGather
from .cuda_patch_gather import patch_gather_centered


def gather_windows_aligned(
    feat: torch.Tensor,
    cell_ids: torch.Tensor,
    grid_hw: Tuple[int, int],
    stride: int,
    window: int,
) -> torch.Tensor:
    """Gather W x W windows centred at ``stride * cell``.

    Args:
        feat: [N, H, W, C] fine feature map with H = stride * h_c, W = stride * w_c.
        cell_ids: [N, K] flat coarse-cell ids (row-major over grid_hw);
            out-of-range ids (padded match slots) give all-zero windows.
        grid_hw: (h_c, w_c) coarse grid shape.
        stride: fine pixels per coarse cell.
        window: odd window size W.
    Returns:
        [N, K, W*W, C] windows in feat's dtype; taps outside the map are zero.
        Differentiable in feat (K4 sums the window gradients back).
    """
    n, h, w, c = feat.shape
    h_c, w_c = grid_hw
    if h != stride * h_c or w != stride * w_c:
        raise ValueError(f"feat {tuple(feat.shape)} != stride {stride} * grid {grid_hw}")
    return WindowGather.apply(feat, cell_ids, grid_hw, stride, window)


def gather_windows(feat: torch.Tensor, centers_rc: torch.Tensor, window: int) -> torch.Tensor:
    """Gather W x W windows around arbitrary integer centers.

    Args:
        feat: [N, H, W, C] feature map.
        centers_rc: [N, K, 2] integer (row, col) window centers.
        window: odd window size W.
    Returns:
        [N, K, W*W, C] windows in feat's dtype; taps outside the map are zero.
        On the card one K6 launch reads the centres as they are (int32 or
        int64) and subtracts W // 2 itself.
    """
    return patch_gather_centered(feat, centers_rc, window)
