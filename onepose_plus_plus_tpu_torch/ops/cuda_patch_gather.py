"""K6: the W x W patch gather at any integer corner, as a hand-written CUDA kernel.

Replaces ``onepose_plus_plus_tpu/ops/pallas_patch_gather.py::gather_patches_dma``
(the function that reaches ``pl.pallas_call`` at :130); source
``csrc/patch_gather.cu``. Its callers are ``ops/window_gather.py::gather_windows``,
which the LoFTR ``refine`` mode runs (SfM fine refinement and descriptor
extraction), and ``models/backbone.py::ResNetFPN_8_2.fine_windows``, the
sparse fine FPN of the query step (``fine.sparse_fpn``), which gathers halo
patches of the 196-channel pin map.

The TPU kernel copied an (8, 128)-aligned superset block per patch out of a map
padded by W on every side, then sliced the true window out with XLA gathers
over the residues: Mosaic cannot prove an arbitrary DMA offset aligned. The
card has no such rule, so the kernel reads each tap straight from the unpadded
NHWC map and writes zeros for the taps outside it; there is no padded copy of
the map and no second slicing pass. One block per patch, vector copies with
neighbouring threads on neighbouring addresses: 16-byte vectors where a
pixel's bytes and both base pointers are multiples of 16, else 8 (a bf16
pixel of 196 channels is 392 bytes), else 4, else 2 (a bf16 pixel of an odd
number of channels; :func:`vector_bytes`), so any C runs. Bound:
device-memory bandwidth (one write of the output, one read of the pixels the
patches cover).
There is no gradient: the TPU kernel has none either, and ``refine`` runs only
at inference.
"""
from __future__ import annotations

import torch

from ..kernels import KERNEL_DTYPES, LAUNCHES, build, check_cuda_operands, ptr, stream_ptr, vector_bytes


def patch_taps(row0: torch.Tensor, col0: torch.Tensor, hw, window: int):
    """Flat map index [N, K*W*W] of every tap (clamped into the map) and whether
    the tap lies on the map."""
    n, k = row0.shape
    h, w = hw
    offs = torch.arange(window, device=row0.device)
    rows = row0.long()[..., None] + offs  # [N, K, W]
    cols = col0.long()[..., None] + offs
    valid = ((rows >= 0) & (rows < h))[..., :, None] & ((cols >= 0) & (cols < w))[..., None, :]
    flat = rows.clamp(0, h - 1)[..., :, None] * w + cols.clamp(0, w - 1)[..., None, :]
    return flat.reshape(n, k * window * window), valid.reshape(n, k * window * window)


def patch_gather_plain(
    feat: torch.Tensor, row0: torch.Tensor, col0: torch.Tensor, window: int
) -> torch.Tensor:
    """Plain PyTorch version of K6 (indexed gather + zero mask; exact)."""
    n, h, w, c = feat.shape
    k = row0.shape[1]
    flat, valid = patch_taps(row0, col0, (h, w), window)
    out = torch.gather(feat.reshape(n, h * w, c), 1, flat[..., None].expand(-1, -1, c))
    out = out.reshape(n, k, window * window, c)
    valid = valid.reshape(n, k, window * window, 1)
    return torch.where(valid, out, torch.zeros_like(out))


def patch_gather(
    feat: torch.Tensor, row0: torch.Tensor, col0: torch.Tensor, window: int
) -> torch.Tensor:
    """W x W patches of feat [N, H, W, C] with top-left corners (row0, col0)
    [N, K] -> [N, K, W*W, C] in feat's dtype (float32 or bfloat16).

    Taps outside the map are zero; a corner entirely off the map gives a zero
    patch. CPU tensors run the plain version; a CUDA tensor launches K6.
    """
    if feat.device.type == "cpu":
        return patch_gather_plain(feat, row0, col0, window)
    if feat.dtype not in KERNEL_DTYPES:
        raise ValueError(f"patch_gather: unsupported dtype {feat.dtype}")
    n, h, w, c = feat.shape
    if row0.shape != col0.shape or row0.dim() != 2 or row0.shape[0] != n:
        raise ValueError(f"patch_gather: corners {tuple(row0.shape)} / {tuple(col0.shape)} "
                         f"vs feat {tuple(feat.shape)}")
    r0 = row0.to(torch.int32).contiguous()
    c0 = col0.to(torch.int32).contiguous()
    device = check_cuda_operands("patch_gather", feat, r0, c0)
    k = r0.shape[1]
    out = torch.empty((n, k, window * window, c), dtype=feat.dtype, device=device)
    vec = vector_bytes(c * feat.element_size(), feat.data_ptr(), out.data_ptr())
    build().call(
        f"opp_patch_gather_{KERNEL_DTYPES[feat.dtype]}",
        ptr(feat), ptr(r0), ptr(c0), ptr(out), n, h, w, c, k, window, vec, stream_ptr(device),
    )
    LAUNCHES["K6_patch_gather"] += 1
    return out
