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
over the residues: Mosaic cannot prove an arbitrary DMA offset aligned. On the
card the patch is a copy of byte spans: in NHWC the in-map taps of a patch row
are one contiguous span of the map and the patch row one contiguous span of
the output, so a thread moves 16 aligned bytes at a time whatever the pixel's
width (one block a patch), realigning two aligned loads by a funnel shift and
zeroing the clipped taps (:func:`patch_spans` per patch row,
:func:`patch_chunks` per 16-byte chunk: the kernel's arithmetic, held against
the plain version by the CPU tests).
The kernel reads the corners in the caller's integer type (int32 or int64)
and strides, plus a constant offset (:func:`patch_gather_centered`), so a
call makes one launch and no cast. Bound: device-memory bandwidth (one write
of the output, one read of the pixels the patches cover).
There is no gradient: the TPU kernel has none either, and ``refine`` runs only
at inference.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..kernels import KERNEL_DTYPES, LAUNCHES, build, check_cuda_operands, ptr, stream_ptr

VECTOR = 16  # bytes a thread loads and stores
MAGIC_SHIFT = 48  # a chunk slot's patch row is (slot * magic) >> 48
MAX_WINDOW = 255
CORNER_TYPES = {torch.int32: "i32", torch.int64: "i64"}


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


def chunk_slots(pixel_bytes: int, window: int) -> Tuple[int, int]:
    """(cmax, magic): the chunk slots K6 gives a patch row, the most 16-byte
    output chunks a row of window * pixel_bytes bytes touches (rows start at
    multiples of gcd(row, 16) past the output's 16-byte alignment), and the
    multiplier that turns a patch's slot t into its row, (t * magic) >> 48.
    Raises ``ValueError`` for what the kernel does not take: a window outside
    1..255, an odd pixel, a patch of 2^31 bytes or more, rows too long for the
    multiply to stay exact (window * cmax^2 >= 2^48)."""
    if not 0 < window <= MAX_WINDOW:
        raise ValueError(f"patch_gather: window {window} outside 1..{MAX_WINDOW}")
    if pixel_bytes <= 0 or pixel_bytes % 2:
        raise ValueError(f"patch_gather: a pixel of {pixel_bytes} bytes is not whole 2-byte halves")
    row = window * pixel_bytes
    if window * row >= (1 << 31) - 64:
        raise ValueError(f"patch_gather: a patch of {window} rows of {row} bytes is too large")
    g = VECTOR
    while row % g:
        g //= 2
    cmax = (VECTOR - g + row + VECTOR - 1) // VECTOR
    if window * cmax * cmax >= 1 << MAGIC_SHIFT:
        raise ValueError(f"patch_gather: rows of {row} bytes are too long for the kernel's slot arithmetic")
    return cmax, ((1 << MAGIC_SHIFT) + cmax - 1) // cmax


def patch_spans(
    row0: torch.Tensor, col0: torch.Tensor, hw: Tuple[int, int], pixel_bytes: int, window: int, *,
    offset: int = 0, feat_addr: int = 0, out_addr: int = 0,
) -> Dict[str, torch.Tensor]:
    """What K6 computes for every patch row: [N, K, window] int64 tensors of
    byte addresses (the map at ``feat_addr``, the output at ``out_addr``).

    ``dst`` the row's output span (window * pixel_bytes bytes from it), of
    which ``head`` zero bytes, then ``length`` bytes copied from the map at
    ``src``, then ``tail`` zero bytes (a row off the map, or clipped to no tap,
    is all head); ``delta`` the map address minus the output address of any
    byte of the row (the kernel's per-row constant); ``shift`` = delta mod 16,
    the realignment; ``fetch_lo`` / ``fetch_hi`` the aligned 16-byte vectors
    the row's chunks load, clamped into those the map touches (empty where
    nothing is copied). The corners are ``row0 + offset``, ``col0 + offset``.
    """
    chunk_slots(pixel_bytes, window)
    if feat_addr % 2 or out_addr % VECTOR:
        raise ValueError("patch_gather: the map must be 2-byte aligned and the output 16-byte aligned")
    n, k = row0.shape
    h, w = hw
    dev = row0.device
    p, row = pixel_bytes, window * pixel_bytes
    r0 = row0.long() + offset
    c0 = col0.long() + offset
    dr = torch.arange(window, device=dev)
    r = r0[..., None] + dr  # [N, K, window]
    cl, ch = c0.clamp(min=0), torch.clamp(c0 + window, max=w)
    copy_lo = torch.where(ch > cl, (cl - c0) * p, 0)[..., None]
    copy_hi = torch.where(ch > cl, (ch - c0) * p, 0)[..., None]
    on_map = (r >= 0) & (r < h)
    length = torch.where(on_map, copy_hi - copy_lo, 0)
    head = torch.where(length > 0, copy_lo, row)
    slot = torch.arange(n, device=dev)[:, None] * k + torch.arange(k, device=dev)
    dst = out_addr + (slot[..., None] * window + dr) * row
    img = feat_addr + torch.arange(n, device=dev)[:, None, None] * (h * w * p)
    delta = img + (r * w + c0[..., None]) * p - dst
    src = torch.where(length > 0, dst + head + delta, 0)
    vec_lo = feat_addr & -VECTOR
    vec_hi = (feat_addr + n * h * w * p - 1) & -VECTOR
    first = (dst + head) & -VECTOR  # the first and last chunk holding copied bytes
    last = (dst + head + length - 1) & -VECTOR
    fetch_lo = ((first + delta) & -VECTOR).clamp(vec_lo, vec_hi)
    fetch_hi = (((last + delta) & -VECTOR) + VECTOR).clamp(vec_lo, vec_hi) + VECTOR
    copied = length > 0
    return {"dst": dst, "head": head, "src": src, "length": length, "tail": row - head - length,
            "delta": delta, "shift": torch.where(copied, delta % VECTOR, 0),
            "fetch_lo": torch.where(copied, fetch_lo, 0), "fetch_hi": torch.where(copied, fetch_hi, 0),
            "vec_lo": torch.tensor(vec_lo), "vec_hi": torch.tensor(vec_hi)}


def patch_chunks(spans: Dict[str, torch.Tensor], pixel_bytes: int, window: int) -> Dict[str, torch.Tensor]:
    """K6's loop over :func:`patch_spans`: [N, K, window * cmax] tensors, one
    entry a chunk slot t of a patch: chunk c = t - dr * cmax of patch row dr
    = (t * magic) >> 48 (:func:`chunk_slots`). A row's chunks are the 16-byte
    aligned output chunks from the one holding its first byte; ``a`` a
    chunk's address, ``live`` whether it touches the row; the bytes
    [s_lo, s_hi) of it that lie in the row are stored; of those, [lo, hi)
    come from the map, by the 32 bytes of the aligned vectors ``f0`` and
    ``f1`` from byte ``o`` on (``copy``: any byte does; ``f1`` is loaded only
    where ``need1``, o + hi > 16), the rest are zero. ``f0`` is raised to the
    map's first vector where it holds no map byte (its bytes are all zeroed)."""
    cmax, magic = chunk_slots(pixel_bytes, window)
    row = window * pixel_bytes
    t = torch.arange(window * cmax, device=spans["dst"].device)
    dr = (t * magic) >> MAGIC_SHIFT
    c = t - dr * cmax
    start = spans["dst"][..., dr]
    a = (start & -VECTOR) + VECTOR * c
    live = a < start + row
    head, length = spans["head"][..., dr], spans["length"][..., dr]
    lo = (start + head - a).clamp(0, VECTOR)
    hi = (start + head + length - a).clamp(0, VECTOR)
    copy = live & (hi > lo)
    src = a + spans["delta"][..., dr]
    o = src % VECTOR
    v = src - o
    return {"a": a, "live": live, "s_lo": (start - a).clamp(0, VECTOR), "s_hi": (start + row - a).clamp(0, VECTOR),
            "lo": lo, "hi": hi, "copy": copy, "o": o, "need1": copy & (o + hi > VECTOR),
            "f0": v.clamp(min=int(spans["vec_lo"])), "f1": v + VECTOR}


def _launch(feat: torch.Tensor, row0: torch.Tensor, col0: torch.Tensor, window: int,
            offset: int) -> torch.Tensor:
    """One K6 launch on the card: corners ``row0 + offset``, ``col0 + offset``
    read in place (int32 or int64, any strides)."""
    if feat.dtype not in KERNEL_DTYPES:
        raise ValueError(f"patch_gather: unsupported dtype {feat.dtype}")
    n, h, w, c = feat.shape
    if row0.shape != col0.shape or row0.dim() != 2 or row0.shape[0] != n or row0.shape[1] == 0 or n > 65535:
        raise ValueError(f"patch_gather: corners {tuple(row0.shape)} / {tuple(col0.shape)} "
                         f"vs feat {tuple(feat.shape)}")
    if row0.dtype not in CORNER_TYPES or col0.dtype != row0.dtype:
        raise ValueError(f"patch_gather: corners of {row0.dtype} / {col0.dtype}, not both int32 or int64")
    device = check_cuda_operands("patch_gather", feat)
    if row0.device != device or col0.device != device:
        raise ValueError(f"patch_gather: corners on {row0.device} / {col0.device}, feat on {device}")
    pixel = c * feat.element_size()
    chunk_slots(pixel, window)
    k = row0.shape[1]
    out = torch.empty((n, k, window * window, c), dtype=feat.dtype, device=device)
    build().call(
        f"opp_patch_gather_{CORNER_TYPES[row0.dtype]}",
        ptr(feat), ptr(row0), ptr(col0), ptr(out), *row0.stride(), *col0.stride(),
        n, k, h, w, pixel, window, offset, stream_ptr(device),
    )
    LAUNCHES["K6_patch_gather"] += 1
    return out


def patch_gather(
    feat: torch.Tensor, row0: torch.Tensor, col0: torch.Tensor, window: int
) -> torch.Tensor:
    """W x W patches of feat [N, H, W, C] with top-left corners (row0, col0)
    [N, K] -> [N, K, W*W, C] in feat's dtype (float32 or bfloat16).

    Taps outside the map are zero; a corner entirely off the map gives a zero
    patch. CPU tensors run the plain version; a CUDA tensor launches K6, which
    reads int32 or int64 corners of any strides as they are.
    """
    if feat.device.type == "cpu":
        return patch_gather_plain(feat, row0, col0, window)
    return _launch(feat, row0, col0, window, 0)


def patch_gather_centered(feat: torch.Tensor, centers_rc: torch.Tensor, window: int) -> torch.Tensor:
    """W x W patches of feat [N, H, W, C] centred at the integer (row, col)
    ``centers_rc`` [N, K, 2] (odd W): :func:`patch_gather` at corners
    ``centers_rc - W // 2``. On the card the offset is K6's argument and the
    two columns are read in place: one launch."""
    half = window // 2
    if feat.device.type == "cpu":
        return patch_gather_plain(feat, centers_rc[..., 0] - half, centers_rc[..., 1] - half, window)
    return _launch(feat, centers_rc[..., 0], centers_rc[..., 1], window, -half)
