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
reads; 105 MB in bf16 at the query step's shapes). :func:`window_instance`
picks one of two instances by the pixel's bytes and the pointers. Where a
pixel is a multiple of 16 bytes and both pointers are 16-byte aligned (the
main path's 128-channel pixels), one warp copies a window as 16-byte vectors
with 13 loads a lane in flight, all issued before the lane's stores; a
vector's tap and the tap's window row come from a shift and a multiply, not a
division (:func:`window_vector_sources` is that arithmetic in PyTorch, held to
the plain version by the CPU tests). Every other pixel runs K6's span copy,
16 aligned output bytes a lane whatever the pixel's width, with each window's
corner derived from its cell id in the kernel (:func:`window_span_corners`;
``ops/cuda_patch_gather.py::patch_spans`` and ``patch_chunks`` are the rest
of that arithmetic).

K4 is K3's transpose: window gradients summed back onto the map. Windows
overlap and GT-padded slots repeat cells, so collisions are the norm; the sum
is deterministic, bit for bit, with no float atomics. Bound: bandwidth again
(one write of the map, one read of each gradient tap). The wrapper makes two
hand-written launches and nothing else: an index kernel that orders the slots
by cell id, ranking each slot by brute force over the staged ids and each
cell by a block's histogram (:func:`scatter_index_plain` is its plain
version, held exactly equal), and
the span sum at every pixel, one block per map row (or piece of a long one)
with that row's index ranges and slots in shared memory, summing in f32 and
in a fixed order (cells in row, column order, each cell's slots ascending)
the slots of the at most ceil(W/stride)^2 cells whose windows hold a pixel: a
thread owns aligned 16-byte chunks of a map row and reads each window's tap
row as a span, funnel-shifted into place, adding an element only where its
pixel lies in the window (:func:`window_sum_chunks` does the same on bytes,
held bitwise to that order by the CPU tests).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import KERNEL_DTYPES, LAUNCHES, build, check_cuda_operands, ptr, stream_ptr

def window_instance(pixel_bytes: int, *pointers: int) -> str:
    """The instance K3 runs a pixel of ``pixel_bytes`` in, given the data
    pointers of the call: ``"vector"`` (a warp a window in 16-byte vectors)
    where the pixel and every pointer are multiples of 16 bytes, else
    ``"span"`` (K6's span copy, 16-byte chunks at any pixel)."""
    if pixel_bytes % 16 == 0 and all(p % 16 == 0 for p in pointers):
        return "vector"
    return "span"


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
    """The source of every vector K3's 16-byte instance writes, by the kernel's
    own arithmetic: [N, K, W*W*nv] flat vector indices into one image's
    [H*W*nv] 16-byte vectors (nv a pixel), -1 where the vector is zero. Vector
    i of a window is vector i % nv of tap t = i // nv (a shift where nv is a
    power of two), and the tap's window row is (t * magic) >> 20 with
    magic = ceil(2^20 / window)."""
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


def window_span_corners(
    cell_ids: torch.Tensor, grid_hw: Tuple[int, int], stride: int, window: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The patch corners (row0, col0) [N, K] int64 that K3's span instance
    derives from the cell ids in the kernel: (stride*ci - W/2, stride*cj - W/2)
    for an id ci * wc + cj of the grid, (-W, -W) (every tap off the map) for an
    id outside it. ``ops/cuda_patch_gather.py::patch_spans`` of these corners
    is the rest of the kernel's arithmetic."""
    h_c, w_c = grid_hw
    ids = cell_ids.long()
    ok = (ids >= 0) & (ids < h_c * w_c)
    ci = torch.where(ok, ids // w_c, 0)
    cj = torch.where(ok, ids - ci * w_c, 0)
    half = window // 2
    return torch.where(ok, ci * stride - half, -window), torch.where(ok, cj * stride - half, -window)


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
    feat's dtype (float32 or bfloat16). CPU tensors run the plain version; a
    CUDA tensor makes one K3 launch, of the instance :func:`window_instance`
    picks.
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
    ids = cell_ids if cell_ids.dtype == torch.int32 else cell_ids.to(torch.int32)  # the model's are
    if not ids.is_contiguous():
        ids = ids.contiguous()
    device = check_cuda_operands("window_gather", feat, ids)
    k = ids.shape[1]
    out = torch.empty((n, k, window * window, c), dtype=feat.dtype, device=device)
    pixel = c * feat.element_size()
    instance = window_instance(pixel, feat.data_ptr(), out.data_ptr())
    entry = {"vector": "opp_window_gather", "span": "opp_window_span"}[instance]
    build().call(entry, ptr(feat), ptr(ids), ptr(out), n, h, w, pixel, h_c, w_c, k, stride, window,
                 stream_ptr(device))
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


def _cell_range(x: torch.Tensor, window: int, stride: int, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """csrc/scatter.cu::cell_range: the cells c whose window (stride*c - W/2
    ... stride*c - W/2 + W - 1) holds x, clipped to [0, n)."""
    half = window // 2
    below = x + half - window + 1
    lo = torch.where(below <= 0, 0, (below + stride - 1) // stride)
    return lo, ((x + half) // stride).clamp(max=n - 1)


def window_sum_chunks(
    mem: torch.Tensor, grad_addr: int, out_addr: int, cell_ids: torch.Tensor, grid_hw: Tuple[int, int],
    stride: int, window: int, hw: Tuple[int, int], channels: int, dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4's span sum (``window_sum_kernel``) done on bytes, by the kernel's own
    arithmetic: ``mem`` (uint8) holds the gradient [N, K, W*W, C] of ``dtype``
    at byte ``grad_addr``; the map [N, H, W, C] goes to ``out_addr``.

    Every map row (b, r) is the span [start, start + W * P) for a pixel of P
    bytes, cut into the aligned 16-byte chunks that touch it. A chunk sums, in
    f32, for the cell rows in reach of r (ascending), the cell columns in reach
    of its pixels (ascending) and each cell's slots in ``order`` (ascending):
    the 16 gradient bytes at chunk address + delta (delta = the window's tap
    row less the map row, by its first pixel column), loaded as the aligned
    vector f0 holding them (raised to the gradient's first vector where it
    lies below it) and, where they run past it, f1 = f0 + 16, funnel-shifted
    by their address mod 16; an element adds only where its bytes lie inside
    the window's columns on the map. The sums are rounded to ``dtype`` and a
    chunk stores its bytes in the row. Returns the map's bytes (0xEE where no
    chunk stored), the address of every vector loaded and the offset into the
    map of every byte stored."""
    esize = torch.tensor([], dtype=dtype).element_size()
    n, k = cell_ids.shape
    h, w = hw
    h_c, w_c = grid_hw
    p, taps, half = channels * esize, window * window, window // 2
    if grad_addr % esize or out_addr % esize:
        raise ValueError("window_scatter: the gradient and the map must be aligned to their element")
    dev = cell_ids.device
    order, cell_start = (t.long() for t in scatter_index_plain(cell_ids, h_c * w_c))
    pitch = w * p
    b = torch.arange(n, device=dev)[:, None, None]
    r = torch.arange(h, device=dev)[None, :, None]
    start = out_addr + (b * h + r) * pitch  # [N, H, 1]
    first = start & -16
    n_chunks = (((start + pitch + 15) & -16) - first) // 16
    t = torch.arange(int(n_chunks.max()), device=dev)
    a_addr = first + 16 * t  # [N, H, T]
    live = t < n_chunks
    s_lo = (start - a_addr).clamp(0, 16)
    s_hi = (start + pitch - a_addr).clamp(0, 16)
    x_lo = ((a_addr + s_lo - start) // p).clamp(0, w - 1)
    x_hi = ((a_addr + s_hi - 1 - start) // p).clamp(0, w - 1)
    col_lo, col_hi = _cell_range(torch.arange(w, device=dev), window, stride, w_c)
    j_lo, j_hi = col_lo[x_lo], col_hi[x_hi]
    ci_lo, ci_hi = _cell_range(r, window, stride, h_c)
    n_ci = (ci_hi - ci_lo + 1).clamp(min=0)
    e = torch.arange(16 // esize, device=dev) * esize  # each element's first byte in the chunk
    j16 = torch.arange(16, device=dev)
    acc = torch.zeros((*a_addr.shape, 16 // esize), dtype=torch.float32, device=dev)
    vec_lo = grad_addr & -16
    g_img = grad_addr + b * k * taps * p
    top = mem.numel() - 16
    loads = []
    for a in range((window - 1) // stride + 1):
        ci = ci_lo + a
        tr = r - (stride * ci - half)
        for jj in range(int((j_hi - j_lo).max()) + 1):
            j = j_lo + jj
            cell = (ci * w_c + j).clamp(0, h_c * w_c - 1).expand_as(a_addr)
            ok_cell = live & (a < n_ci) & (j <= j_hi)
            s0 = torch.gather(cell_start, 1, cell.reshape(n, -1)).view_as(cell)
            s1 = torch.gather(cell_start, 1, cell.reshape(n, -1) + 1).view_as(cell)
            c0 = stride * j - half
            lo = torch.maximum(s_lo, start + c0.clamp(min=0) * p - a_addr)
            hi = torch.minimum(s_hi, start + (c0 + window).clamp(max=w) * p - a_addr)
            ok_cell = ok_cell & (hi > lo)
            src0 = a_addr + g_img + (tr * window - c0) * p - start
            for u in range(int(torch.where(ok_cell, s1 - s0, 0).max())):
                s = s0 + u
                ok = ok_cell & (s < s1)
                slot = torch.gather(order, 1, s.clamp(max=k - 1).reshape(n, -1)).view_as(s)
                src = src0 + slot * (taps * p)
                o = src % 16
                f1 = src - o + 16
                f0 = (f1 - 16).clamp(min=vec_lo)
                need1 = ok & (o != 0) & (o + hi > 16)
                loads += [f0[ok], f1[need1]]
                v0 = mem[f0.clamp(0, top)[..., None] + j16]
                v1 = torch.where(need1[..., None], mem[f1.clamp(0, top)[..., None] + j16], 0)
                val = torch.gather(torch.cat([v0, v1], -1), -1, o[..., None] + j16)
                x = val.contiguous().view(dtype).float()
                inside = ok[..., None] & (e >= lo[..., None]) & (e < hi[..., None])
                acc = torch.where(inside, acc + x, acc)
    packed = acc.to(dtype).view(torch.uint8)  # [N, H, T, 16]
    store = live[..., None] & (j16 >= s_lo[..., None]) & (j16 < s_hi[..., None])
    pos = (a_addr[..., None] + j16 - out_addr)[store]
    out = torch.full((n * h * w * p,), 0xEE, dtype=torch.uint8, device=dev)
    out[pos] = packed[store]
    return out, torch.cat(loads) if loads else torch.zeros(0, dtype=torch.long, device=dev), pos


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
    Output has grad's dtype. CPU tensors run the plain version; a CUDA tensor
    makes K4's two launches, the index and the span sum.
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
    if not grad.is_contiguous():
        grad = grad.contiguous()
    ids = cell_ids if cell_ids.dtype == torch.int32 else cell_ids.to(torch.int32)  # the model's are
    device = check_cuda_operands("window_scatter", grad, ids)
    scratch = torch.empty(n * (k + h_c * w_c + 1), dtype=torch.int32, device=device)  # order, cell_start
    out = torch.empty((n, h, w, c), dtype=grad.dtype, device=device)
    order = scratch.data_ptr()
    build().call(
        f"opp_window_scatter_{KERNEL_DTYPES[grad.dtype]}",
        ptr(grad), ptr(ids), order, order + 4 * n * k, ptr(out), n, h, w, c, h_c, w_c, k,
        stride, window, stream_ptr(device),
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
