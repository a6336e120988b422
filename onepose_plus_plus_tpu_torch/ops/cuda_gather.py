"""K3 and K4: the fine-window gather and its VJP as hand-written CUDA kernels.

K3 replaces ``onepose_plus_plus_tpu/ops/pallas_gather.py::take_rows_mxu`` as
``ops/window_gather.py::gather_windows_aligned`` uses it (window_gather.py:
109-119); source ``csrc/gather.cu``. K4 replaces ``scatter_rows_mxu``, the
backward of ``take_rows_mxu_grad`` there; source ``csrc/scatter.cu``.
``WindowGather`` joins them as one ``torch.autograd.Function`` (the ids carry
no gradient).

On the TPU the window gather is a one-hot matmul over a space-to-depth copy of
the map, because the matrix unit is the only fast way to select rows there.
Both exist only for the TPU: the kernel copies each W x W window straight from
the NHWC map into ``[B, K, W*W, C]``. Taps outside the map, and every tap of an
out-of-range cell id (a padded match slot), are zero.

What bounds K3 on the card: device-memory bandwidth (the output and the taps it
reads; 105 MB in bf16 at the query step's shapes). The design gives each
window one warp, which copies it as vectors with 13 loads a lane in flight,
all issued before the lane's stores; neighbouring lanes move neighbouring
vectors, so loads and stores coalesce. The vector is the widest of 16, 8, 4
and 2 bytes that divides a pixel's bytes and both base pointers
(``kernels.vector_bytes``): the main path's 128-channel pixels take 16 bytes,
and a pixel of any width runs. A vector's tap and the tap's window row come
from a shift and a multiply, not a division (:func:`window_vector_sources` is
that arithmetic in PyTorch, held to the plain version by the CPU tests).

K4 is K3's transpose: window gradients summed back onto the map. Windows
overlap and GT-padded slots repeat cells, so collisions are the norm; the sum
is deterministic, bit for bit, with no atomics. Bound: bandwidth again (one
write of the map, one read of each gradient tap). What held the first version
back on the card was not the bound but its index preparation, eight PyTorch
launches (a library sort, ``searchsorted``, casts) before the one kernel. Now
the wrapper makes two hand-written launches and nothing else: an index kernel
that orders the slots by cell id with a brute-force counting sort spread over
the card (:func:`scatter_index_plain` is its plain version, held exactly
equal), and the scatter itself, one block per map row with that row's index
ranges in shared memory and one thread per vector (as wide as K3's) summing,
in a fixed order and in f32, the slots of the at most ceil(W/stride)^2 cells
whose windows hold its pixel.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import KERNEL_DTYPES, LAUNCHES, build, check_cuda_operands, ptr, stream_ptr, vector_bytes


def _window_taps(
    cell_ids: torch.Tensor, hw: Tuple[int, int], grid_hw: Tuple[int, int], stride: int, window: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat map index [N, K*W*W] (clamped into the map) and validity of every tap."""
    n, k = cell_ids.shape
    h, w = hw
    h_c, w_c = grid_hw
    ids = cell_ids.long()
    in_range = (ids >= 0) & (ids < h_c * w_c)
    ci, cj = ids // w_c, ids % w_c
    offs = torch.arange(window, device=cell_ids.device) - window // 2
    rows = stride * ci[..., None] + offs  # [N, K, W]
    cols = stride * cj[..., None] + offs
    valid = (
        in_range[..., None, None]
        & ((rows >= 0) & (rows < h))[..., :, None]
        & ((cols >= 0) & (cols < w))[..., None, :]
    )  # [N, K, W, W]
    flat = rows.clamp(0, h - 1)[..., :, None] * w + cols.clamp(0, w - 1)[..., None, :]
    return flat.reshape(n, k * window * window), valid.reshape(n, k * window * window)


MAGIC_SHIFT, MAX_WINDOW = 20, 63  # csrc/gather.cu: tap // window as (tap * magic) >> 20


def window_vector_sources(
    cell_ids: torch.Tensor, hw: Tuple[int, int], grid_hw: Tuple[int, int], stride: int, window: int,
    nv: int,
) -> torch.Tensor:
    """The source of every vector K3 writes, by the kernel's own arithmetic:
    [N, K, W*W*nv] flat vector indices into one image's [H*W*nv] vectors (nv
    vectors a pixel, of whichever width the wrapper picked), -1 where the
    vector is zero. Vector i of a window is vector i % nv of tap t = i // nv
    (a shift where nv is a power of two), and the tap's window row is
    (t * magic) >> 20 with magic = ceil(2^20 / window)."""
    if not 0 < window <= MAX_WINDOW:
        raise ValueError(f"window_gather: window {window} outside 1..{MAX_WINDOW}")
    h, w = hw
    h_c, w_c = grid_hw
    ids = cell_ids.long()
    ok = (ids >= 0) & (ids < h_c * w_c)
    ci = torch.where(ok, ids // w_c, 0)
    cj = torch.where(ok, ids - ci * w_c, 0)
    i = torch.arange(window * window * nv, device=cell_ids.device)
    t = i >> (nv.bit_length() - 1) if nv & (nv - 1) == 0 else i // nv
    v = i - t * nv
    magic = ((1 << MAGIC_SHIFT) + window - 1) // window
    dr = (t * magic) >> MAGIC_SHIFT
    dc = t - dr * window
    r = (ci * stride - window // 2)[..., None] + dr
    c = (cj * stride - window // 2)[..., None] + dc
    inside = ok[..., None] & (r >= 0) & (r < h) & (c >= 0) & (c < w)
    return torch.where(inside, (r * w + c) * nv + v, -1)


def window_gather_plain(
    feat: torch.Tensor,
    cell_ids: torch.Tensor,
    grid_hw: Tuple[int, int],
    stride: int,
    window: int,
) -> torch.Tensor:
    """Plain PyTorch version of K3 (indexed gather + zero mask; exact)."""
    n, h, w, c = feat.shape
    k = cell_ids.shape[1]
    flat, valid = _window_taps(cell_ids, (h, w), grid_hw, stride, window)
    out = torch.gather(feat.reshape(n, h * w, c), 1, flat[..., None].expand(-1, -1, c))
    out = out.reshape(n, k, window * window, c)
    valid = valid.reshape(n, k, window * window, 1)
    return torch.where(valid, out, torch.zeros_like(out))


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
    if not 0 < window <= MAX_WINDOW:
        raise ValueError(f"window_gather: window {window} outside 1..{MAX_WINDOW}")
    ids = cell_ids.to(torch.int32).contiguous()  # no launch for the model's int32 ids
    device = check_cuda_operands("window_gather", feat, ids)
    k = ids.shape[1]
    out = torch.empty((n, k, window * window, c), dtype=feat.dtype, device=device)
    vec = vector_bytes(c * feat.element_size(), feat.data_ptr(), out.data_ptr())
    build().call(
        f"opp_window_gather_{KERNEL_DTYPES[feat.dtype]}",
        ptr(feat), ptr(ids), ptr(out), n, h, w, c, h_c, w_c, k, stride, window, vec,
        stream_ptr(device),
    )
    LAUNCHES["K3_window_gather"] += 1
    return out


def scatter_index_plain(cell_ids: torch.Tensor, n_cells: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4's index launch.

    ``order`` [N, K] int32: the slots in a stable order of their cell id, ids
    outside ``[0, n_cells)`` last. ``cell_start`` [N, n_cells + 1] int32: the
    number of slots in cells below c, so that cell c's slots are
    ``order[cell_start[c]:cell_start[c + 1]]`` and ``cell_start[n_cells]``
    counts the valid slots.
    """
    n = cell_ids.shape[0]
    ids = cell_ids.long()
    key = torch.where((ids >= 0) & (ids < n_cells), ids, torch.full_like(ids, n_cells))
    sorted_key, order = torch.sort(key, dim=1, stable=True)
    cells = torch.arange(n_cells + 1, device=cell_ids.device).expand(n, -1).contiguous()
    cell_start = torch.searchsorted(sorted_key, cells)
    return order.to(torch.int32), cell_start.to(torch.int32)


def scatter_index(cell_ids: torch.Tensor, n_cells: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's index launch alone: ``(order, cell_start)`` of cell_ids [N, K], as
    :func:`scatter_index_plain` defines them. :func:`window_scatter` makes this
    launch itself; this entry exists to hold it against the plain version.
    CPU tensors run the plain version."""
    if cell_ids.device.type == "cpu":
        return scatter_index_plain(cell_ids, n_cells)
    if cell_ids.dim() != 2 or n_cells <= 0:
        raise ValueError(f"scatter_index: cell_ids {tuple(cell_ids.shape)}, n_cells {n_cells}")
    ids = cell_ids.to(torch.int32)
    device = check_cuda_operands("scatter_index", ids)
    n, k = ids.shape
    order = torch.empty((n, k), dtype=torch.int32, device=device)
    cell_start = torch.empty((n, n_cells + 1), dtype=torch.int32, device=device)
    build().call("opp_window_scatter_index", ptr(ids), ptr(order), ptr(cell_start), n, k, n_cells,
                 stream_ptr(device))
    return order, cell_start


def window_scatter_plain(
    grad: torch.Tensor,
    cell_ids: torch.Tensor,
    grid_hw: Tuple[int, int],
    stride: int,
    window: int,
    hw: Tuple[int, int],
) -> torch.Tensor:
    """Plain PyTorch version of K4: ``index_add_`` of the valid taps into an f32
    zero map, then a cast to grad's dtype."""
    n, k, taps, c = grad.shape
    h, w = hw
    flat, valid = _window_taps(cell_ids, hw, grid_hw, stride, window)
    flat = flat + h * w * torch.arange(n, device=grad.device)[:, None]
    out = torch.zeros((n * h * w, c), dtype=torch.float32, device=grad.device)
    out.index_add_(0, flat[valid], grad.reshape(n, k * taps, c)[valid].float())
    return out.reshape(n, h, w, c).to(grad.dtype)


def window_scatter(
    grad: torch.Tensor,
    cell_ids: torch.Tensor,
    grid_hw: Tuple[int, int],
    stride: int,
    window: int,
    hw: Tuple[int, int],
) -> torch.Tensor:
    """Sum window gradients grad [N, K, W*W, C] back onto an [N, H, W, C] map.

    The transpose of :func:`window_gather`: duplicate and overlapping windows
    add up (in f32), taps outside the map and out-of-range ids are dropped.
    Output has grad's dtype. CPU tensors run the plain version.
    """
    if grad.device.type == "cpu":
        return window_scatter_plain(grad, cell_ids, grid_hw, stride, window, hw)
    if grad.dtype not in KERNEL_DTYPES:
        raise ValueError(f"window_scatter: unsupported dtype {grad.dtype}")
    n, k, taps, c = grad.shape
    h, w = hw
    h_c, w_c = grid_hw
    if cell_ids.shape != (n, k) or taps != window * window:
        raise ValueError(f"window_scatter: cell_ids {tuple(cell_ids.shape)} vs grad {tuple(grad.shape)}")
    if h != stride * h_c or w != stride * w_c:
        raise ValueError(f"window_scatter: map {hw} != stride {stride} * grid {grid_hw}")
    grad = grad.contiguous()
    ids = cell_ids.to(torch.int32)  # a launch only where the caller's ids are not int32
    device = check_cuda_operands("window_scatter", grad, ids)
    order = torch.empty((n, k), dtype=torch.int32, device=device)
    cell_start = torch.empty((n, h_c * w_c + 1), dtype=torch.int32, device=device)
    out = torch.empty((n, h, w, c), dtype=grad.dtype, device=device)
    vec = vector_bytes(c * grad.element_size(), grad.data_ptr(), out.data_ptr())
    build().call(
        f"opp_window_scatter_{KERNEL_DTYPES[grad.dtype]}",
        ptr(grad), ptr(ids), ptr(order), ptr(cell_start), ptr(out), n, h, w, c, h_c, w_c, k,
        stride, window, vec, stream_ptr(device),
    )
    LAUNCHES["K4_window_scatter"] += 1
    return out


class WindowGather(torch.autograd.Function):
    """The window gather with a gradient in feat: forward K3, backward K4."""

    @staticmethod
    def forward(ctx, feat, cell_ids, grid_hw, stride, window):
        cell_ids = cell_ids.to(torch.int32)  # once here, so that the backward casts nothing
        ctx.save_for_backward(cell_ids)
        ctx.geometry = (grid_hw, stride, window, (feat.shape[1], feat.shape[2]))
        return window_gather(feat, cell_ids, grid_hw, stride, window)

    @staticmethod
    def backward(ctx, grad):
        (cell_ids,) = ctx.saved_tensors
        grid_hw, stride, window, hw = ctx.geometry
        return window_scatter(grad, cell_ids, grid_hw, stride, window, hw), None, None, None, None
