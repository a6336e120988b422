"""K3: the fine-window gather as a hand-written CUDA kernel.

Replaces ``onepose_plus_plus_tpu/ops/pallas_gather.py::take_rows_mxu`` as
``ops/window_gather.py::gather_windows_aligned`` uses it (window_gather.py:
109-119). Source: ``csrc/gather.cu``.

On the TPU the window gather is a one-hot matmul over a space-to-depth copy of
the map, because the matrix unit is the only fast way to select rows there.
Both exist only for the TPU: the kernel copies each W x W window straight from
the NHWC map into ``[B, K, W*W, C]``. Taps outside the map, and every tap of an
out-of-range cell id (a padded match slot), are zero.

What bounds it on the card: device-memory bandwidth (the output and the taps it
reads; a few tens of MB at the main-path shapes). The design gives each window
one block and copies 16-byte vectors, neighbouring threads on neighbouring
addresses, so loads and stores coalesce.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import KERNEL_DTYPES, LAUNCHES, build, check_cuda_operands, ptr, stream_ptr


def window_gather_plain(
    feat: torch.Tensor,
    cell_ids: torch.Tensor,
    grid_hw: Tuple[int, int],
    stride: int,
    window: int,
) -> torch.Tensor:
    """Plain PyTorch version of K3 (indexed gather + zero mask; exact)."""
    n, h, w, c = feat.shape
    h_c, w_c = grid_hw
    ids = cell_ids.long()
    k = ids.shape[1]
    in_range = (ids >= 0) & (ids < h_c * w_c)
    ci, cj = ids // w_c, ids % w_c
    offs = torch.arange(window, device=feat.device) - window // 2
    rows = stride * ci[..., None] + offs  # [N, K, W]
    cols = stride * cj[..., None] + offs
    valid = (
        in_range[..., None, None]
        & ((rows >= 0) & (rows < h))[..., :, None]
        & ((cols >= 0) & (cols < w))[..., None, :]
    )  # [N, K, W, W]
    flat = rows.clamp(0, h - 1)[..., :, None] * w + cols.clamp(0, w - 1)[..., None, :]
    flat = flat.reshape(n, k * window * window)
    out = torch.gather(feat.reshape(n, h * w, c), 1, flat[..., None].expand(-1, -1, c))
    out = out.reshape(n, k, window * window, c)
    return torch.where(valid.reshape(n, k, window * window, 1), out, torch.zeros_like(out))


def window_gather(
    feat: torch.Tensor,
    cell_ids: torch.Tensor,
    grid_hw: Tuple[int, int],
    stride: int,
    window: int,
) -> torch.Tensor:
    """W x W windows centred at ``stride * cell`` of feat [N, H, W, C] -> [N, K, W*W, C].

    ``cell_ids`` [N, K] are flat coarse-cell ids over ``grid_hw``. Output has
    feat's dtype (float32 or bfloat16). CPU tensors run the plain version.
    """
    if feat.device.type == "cpu":
        return window_gather_plain(feat, cell_ids, grid_hw, stride, window)
    if feat.dtype not in KERNEL_DTYPES:
        raise ValueError(f"window_gather: unsupported dtype {feat.dtype}")
    n, h, w, c = feat.shape
    h_c, w_c = grid_hw
    if cell_ids.dim() != 2 or cell_ids.shape[0] != n:
        raise ValueError(f"window_gather: cell_ids {tuple(cell_ids.shape)} vs feat {tuple(feat.shape)}")
    if (c * feat.element_size()) % 16 != 0:
        raise ValueError(f"window_gather: C * itemsize must be a multiple of 16 bytes, C={c}")
    ids = cell_ids.to(torch.int32).contiguous()
    device = check_cuda_operands("window_gather", feat, ids)
    k = ids.shape[1]
    out = torch.empty((n, k, window * window, c), dtype=feat.dtype, device=device)
    build().call(
        f"opp_window_gather_{KERNEL_DTYPES[feat.dtype]}",
        ptr(feat), ptr(ids), ptr(out), n, h, w, c, h_c, w_c, k, stride, window,
        stream_ptr(device),
    )
    LAUNCHES["K3_window_gather"] += 1
    return out
