"""Port parity: kernel K3's plain version against JAX ``gather_windows_aligned``.

Both are exact copies on the CPU (the JAX one-hot matmul has one non-zero
term per output), so the outputs must be equal, zero windows included. Then
the kernels' own arithmetic on bytes: K3's 16-byte instance
(``window_vector_sources``) and span instance (``window_span_corners`` and
K6's span plan) against the plain version byte for byte, and K4's span sum
(``window_sum_chunks``) against the sums in the kernel's order, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_plus_plus_tpu.ops.window_gather import gather_windows_aligned as jax_gather
from onepose_plus_plus_tpu_torch import kernels
from onepose_plus_plus_tpu_torch.ops.cuda_gather import (
    scatter_index_plain,
    window_gather,
    window_gather_plain,
    window_instance,
    window_scatter_plain,
    window_span_corners,
    window_sum_chunks,
    window_vector_sources,
)
from onepose_plus_plus_tpu_torch.ops.cuda_patch_gather import patch_chunks, patch_spans
from onepose_plus_plus_tpu_torch.ops.window_gather import gather_windows_aligned
from port_helpers import run_span_chunks

torch.set_num_threads(2)


@pytest.mark.parametrize(
    "grid,stride,window,dtype",
    [
        ((8, 8), 4, 5, np.float32),  # the matcher's fine stage (1/8 -> 1/2)
        ((6, 10), 2, 5, np.float32),
        ((5, 7), 4, 9, np.float32),  # the SfM refine window
        ((8, 8), 4, 5, "bfloat16"),
    ],
)
def test_matches_jax_gather_exactly(grid, stride, window, dtype):
    rng = np.random.default_rng(0)
    h_c, w_c = grid
    n, k, c = 2, 40, 16
    feat = rng.standard_normal((n, stride * h_c, stride * w_c, c)).astype(np.float32)
    ids = rng.integers(0, h_c * w_c, (n, k)).astype(np.int32)
    ids[:, :4] = [-1, h_c * w_c, 0, h_c * w_c - 1]  # two out of range, two corners
    if dtype == "bfloat16":
        ref = jax_gather(jnp.asarray(feat, jnp.bfloat16), jnp.asarray(ids), grid, stride, window)
        ref = np.asarray(ref.astype(jnp.float32))
        feat_t = torch.from_numpy(feat).to(torch.bfloat16)
    else:
        ref = np.asarray(jax_gather(jnp.asarray(feat), jnp.asarray(ids), grid, stride, window))
        feat_t = torch.from_numpy(feat)
    out = gather_windows_aligned(feat_t, torch.from_numpy(ids), grid, stride, window)
    assert out.shape == (n, k, window * window, c) and out.dtype == feat_t.dtype
    np.testing.assert_array_equal(out.float().numpy(), ref)
    assert not out[:, :2].any()  # out-of-range ids give zero windows
    assert out[:, 2:4].any() and not out[:, 2:4].all()  # corner windows: partly off the map


# The narrow pixels: no 16-byte vector divides them, so K3 and K4 run their span
# instances there (bf16 C = 196 is the sparse FPN's pin map)
NARROW = [("bfloat16", 33), ("bfloat16", 130), ("bfloat16", 196), ("float32", 33), ("float32", 130)]


@pytest.mark.parametrize("dtype,c", NARROW)
def test_narrow_pixels_match_jax_gather_and_its_vjp(dtype, c):
    """K3's and K4's plain versions at pixel widths that are not a multiple of
    16 bytes, against the JAX gather and ``jax.vjp`` of it (train=True, the
    one-hot path on the CPU): the gather exactly; the gradient exactly up to f32
    summation order in f32 (atol 1e-6), and in bf16 to one rounding of the sum
    (rtol 2^-8)."""
    rng = np.random.default_rng(c)
    grid, stride, window = (6, 7), 4, 5
    h_c, w_c = grid
    n, k = 2, 30
    feat = rng.standard_normal((n, stride * h_c, stride * w_c, c)).astype(np.float32)
    ids = rng.integers(0, h_c * w_c, (n, k)).astype(np.int32)
    ids[:, :4] = [-1, h_c * w_c, 0, h_c * w_c - 1]
    ids[:, 20:26] = ids[:, 4:10]  # repeated cells
    cot = rng.standard_normal((n, k, window * window, c)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jfeat = jnp.asarray(feat, jdt)
    ref, vjp = jax.vjp(lambda f: jax_gather(f, jnp.asarray(ids), grid, stride, window, train=True), jfeat)
    (ref_grad,) = vjp(jnp.asarray(cot, jdt))
    f = torch.from_numpy(feat).to(tdt).requires_grad_()
    out = gather_windows_aligned(f, torch.from_numpy(ids), grid, stride, window)
    out.backward(torch.from_numpy(cot).to(tdt))
    np.testing.assert_array_equal(out.detach().float().numpy(), np.asarray(ref.astype(jnp.float32)))
    got, want = f.grad.float().numpy(), np.asarray(ref_grad.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=1e-6)


def test_cpu_tensors_never_launch_the_kernel():
    kernels.reset_launch_counts()
    feat = torch.zeros(1, 8, 8, 16)
    window_gather(feat, torch.zeros(1, 3, dtype=torch.int32), (2, 2), 4, 5)
    assert kernels.launch_counts()["K3_window_gather"] == 0


def test_rejects_map_not_matching_grid():
    with pytest.raises(ValueError):
        gather_windows_aligned(torch.zeros(1, 10, 8, 4), torch.zeros(1, 2), (2, 2), 4, 5)


@pytest.mark.parametrize("c,dtype,window,stride", [
    (128, torch.bfloat16, 5, 4),   # the query step: 16 vectors a pixel, 400 a window
    (128, torch.float32, 5, 4),    # training and the f32 demo: 32 a pixel, two warp passes
    (96, torch.bfloat16, 5, 4),    # 12 vectors a pixel: not a power of two, a division
    (8, torch.bfloat16, 9, 2),     # one vector a pixel, the SfM window size
    (16, torch.float32, 63, 1),    # the widest window the kernel takes
    (196, torch.bfloat16, 5, 4),   # the span instance from here on: 392 bytes a pixel
    (130, torch.bfloat16, 5, 4),   # 260 bytes
    (33, torch.bfloat16, 9, 2),    # 66 bytes
    (130, torch.float32, 5, 4),    # 520 bytes
    (33, torch.float32, 5, 4),     # 132 bytes
    (2, torch.float32, 5, 4),      # 8 bytes, two pixels a 16-byte chunk
])
def test_k3_vector_arithmetic_reproduces_the_plain_version(c, dtype, window, stride):
    """K3's arithmetic applied to the map's bytes gives the plain version's
    windows exactly: ragged K, corners off the map, ids out of range. Pixels
    of 16-byte multiples take the 16-byte instance (a shift or division per
    vector, the window row as a multiply by ceil(2^20 / W) and a shift); the
    others the span instance (each window's corner from its cell id, then
    K6's span plan in 16-byte chunks)."""
    grid = (6, 7)
    h, w = stride * grid[0], stride * grid[1]
    rng = np.random.default_rng(3)
    feat = torch.from_numpy(rng.standard_normal((2, h, w, c)).astype(np.float32)).to(dtype)
    ids = torch.from_numpy(rng.integers(-3, 6 * 7 + 3, (2, 13)).astype(np.int32))
    ids[:, :4] = torch.tensor([0, 6, 35, 41], dtype=torch.int32)  # the four corners of the grid
    ref = window_gather_plain(feat, ids, grid, stride, window)
    pixel = c * feat.element_size()
    want = ref.contiguous().view(torch.uint8).reshape(-1)
    if window_instance(pixel, feat.data_ptr()) == "vector":
        nv = pixel // 16
        src = window_vector_sources(ids, (h, w), grid, stride, window, nv)
        vectors = feat.view(torch.uint8).reshape(2, h * w * nv, 16)
        got = torch.stack([torch.where((s >= 0)[..., None], vectors[b][s.clamp_min(0)], 0) for b, s in enumerate(src)])
        assert pixel % 16 == 0
    else:
        got = _span_gather_bytes(feat, ids, grid, stride, window, 0)
        assert pixel % 16 != 0
    assert torch.equal(got.reshape(-1), want)


def _span_gather_bytes(feat, ids, grid, stride, window, base):
    """K3's span instance on the bytes of an allocation that holds the map
    ``base`` bytes past a 16-byte alignment (a view into a larger buffer)."""
    n, h, w, c = feat.shape
    pixel, map_bytes = c * feat.element_size(), feat.numel() * feat.element_size()
    alloc = torch.from_numpy(np.random.default_rng(base).integers(0, 256, -(-(base + map_bytes) // 16) * 16)
                             .astype(np.uint8))
    alloc[base:base + map_bytes] = feat.reshape(-1).view(torch.uint8)
    row0, col0 = window_span_corners(ids, grid, stride, window)
    spans = patch_spans(row0, col0, (h, w), pixel, window, feat_addr=base)
    out_bytes = n * ids.shape[1] * window * window * pixel
    return run_span_chunks(alloc, base, base + map_bytes, patch_chunks(spans, pixel, window), out_bytes)


# (dtype, C, bytes the map starts past an alignment): an f32 map starts at a multiple of 4
SPAN_CASES = [("bfloat16", c, base) for c in (1, 33, 128, 130, 196) for base in (0, 2, 4, 8)] + [
    ("float32", c, base) for c in (1, 33, 128, 130) for base in (0, 4, 8)]


@pytest.mark.parametrize("window,stride", [(5, 4), (9, 2)])
@pytest.mark.parametrize("dtype,c,base", SPAN_CASES)
def test_k3_span_plan_reproduces_the_plain_version(dtype, c, base, window, stride):
    """K3's span instance (cell ids to corners, then K6's span plan) on a map
    ``base`` bytes past an alignment equals the plain version byte for byte:
    windows at the grid's corners, ids out of range on both sides (all-zero
    windows), ragged K. No load leaves the map's 16-byte blocks and every
    output byte is stored once (``run_span_chunks`` asserts both)."""
    torch_dtype = getattr(torch, dtype)
    grid = (6, 7)
    h, w = stride * grid[0], stride * grid[1]
    rng = np.random.default_rng(10 * c + window + base)
    feat = torch.from_numpy(rng.standard_normal((2, h, w, c)).astype(np.float32)).to(torch_dtype)
    ids = torch.from_numpy(rng.integers(-3, 6 * 7 + 3, (2, 11)).astype(np.int32))
    ids[:, :6] = torch.tensor([0, 6, 35, 41, -1, 42], dtype=torch.int32)
    ref = window_gather_plain(feat, ids, grid, stride, window)
    got = _span_gather_bytes(feat, ids, grid, stride, window, base)
    assert torch.equal(got, ref.contiguous().view(torch.uint8).reshape(-1))
    assert not ref[:, 4:6].any()


def test_k3_rejects_windows_its_arithmetic_does_not_cover():
    with pytest.raises(ValueError):
        window_vector_sources(torch.zeros(1, 2, dtype=torch.int32), (8, 8), (2, 2), 4, 65, 16)


@pytest.mark.parametrize("pixel,pointers,want", [
    (512, (0, 4096), "vector"),  # bf16 C = 256 / f32 C = 128: the main path's pixels
    (256, (0, 256), "vector"),  # bf16 C = 128
    (392, (0, 256), "span"),  # bf16 C = 196 (the sparse FPN's pin map)
    (260, (0, 256), "span"),  # bf16 C = 130
    (12, (0, 256), "span"),  # f32 C = 3
    (512, (8, 256), "span"),  # a map that starts 8 bytes past an alignment
    (512, (2, 256), "span"),  # ... or 2 bytes
    (394, (0, 256), "span"),  # bf16 C = 197
    (66, (0, 256), "span"),  # bf16 C = 33
])
def test_window_instance(pixel, pointers, want):
    """K3 runs its 16-byte instance only where the pixel and every pointer are
    multiples of 16 bytes, the span copy elsewhere (K4 has one instance)."""
    assert window_instance(pixel, *pointers) == want


def _kernel_order_sums(grad, ids, grid, stride, window, hw):
    """K4's sums in the kernel's order, written out: the slots in ``order``
    (stably by cell id, so cells in (row, column) order and each cell's slots
    ascending), each window's taps added in f32 onto the map in turn; rounded
    once to grad's dtype."""
    n, k, taps, c = grad.shape
    h, w = hw
    w_c = grid[1]
    order, cell_start = scatter_index_plain(ids, grid[0] * w_c)
    acc = torch.zeros(n, h + 2 * window, w + 2 * window, c)  # a margin for the taps off the map
    for b in range(n):
        for s in order[b, :int(cell_start[b, -1])].tolist():
            ci, cj = divmod(int(ids[b, s]), w_c)
            r0, c0 = window + stride * ci - window // 2, window + stride * cj - window // 2
            acc[b, r0:r0 + window, c0:c0 + window] += grad[b, s].float().reshape(window, window, c)
    return acc[:, window:window + h, window:window + w].to(grad.dtype)


# (dtype, C, bytes the gradient and the map start past an alignment)
K4_SPAN_CASES = [(dtype, c, g, o) for dtype, c in NARROW + [("float32", 128), ("bfloat16", 128)]
                 for g, o in ([(0, 0), (2, 6), (4, 8), (8, 4)] if dtype == "bfloat16" else [(0, 0), (4, 8), (8, 4)])]


@pytest.mark.parametrize("dtype,c,grad_base,out_base", K4_SPAN_CASES)
def test_k4_span_sum_reproduces_the_kernel_order(dtype, c, grad_base, out_base):
    """K4's span sum done on bytes (``window_sum_chunks``: funnel-shifted
    16-byte loads of each window's tap row, an element added only inside its
    window, 16-byte chunks of the map row stored) equals the sums in the
    kernel's order bit for bit, and the plain version within
    ``test_narrow_pixels_match_jax_gather_and_its_vjp``'s tolerances: ragged
    K, repeated cells, ids out of range, -0.0 gradients, the gradient and the
    map 2, 4 or 8 bytes past an alignment (an f32 one at a multiple of 4).
    Every load is an aligned vector of the gradient's 16-byte blocks, and
    every map byte is stored once."""
    torch_dtype = getattr(torch, dtype)
    esize = torch.tensor([], dtype=torch_dtype).element_size()
    grid, stride, window = (6, 7), 4, 5
    h, w = stride * grid[0], stride * grid[1]
    rng = np.random.default_rng(c + grad_base)
    n, k = 2, 29
    grad = torch.from_numpy(rng.standard_normal((n, k, window * window, c)).astype(np.float32)).to(torch_dtype)
    grad.view(-1)[::5] = -0.0
    ids = torch.from_numpy(rng.integers(-3, 6 * 7 + 3, (n, k)).astype(np.int32))
    ids[:, :6] = torch.tensor([0, 6, 35, 41, -1, 42], dtype=torch.int32)
    ids[:, 20:26] = ids[:, 4:10]  # repeated cells
    grad_bytes = grad.numel() * esize
    mem = torch.from_numpy(rng.integers(0, 256, -(-(grad_base + grad_bytes) // 16) * 16).astype(np.uint8))
    mem[grad_base:grad_base + grad_bytes] = grad.reshape(-1).view(torch.uint8)
    got, loads, stored = window_sum_chunks(mem, grad_base, out_base, ids, grid, stride, window, (h, w), c,
                                           torch_dtype)
    want = _kernel_order_sums(grad, ids, grid, stride, window, (h, w))
    assert torch.equal(got, want.reshape(-1).view(torch.uint8))
    assert bool((loads % 16 == 0).all()) and bool((loads >= grad_base // 16 * 16).all())
    assert bool((loads < grad_base + grad_bytes).all())
    assert torch.equal(torch.bincount(stored, minlength=got.numel()), torch.ones(got.numel(), dtype=torch.long))
    plain = window_scatter_plain(grad, ids, grid, stride, window, (h, w))
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else dict(rtol=2 ** -8, atol=1e-6)
    np.testing.assert_allclose(want.float().numpy(), plain.float().numpy(), **tol)


@pytest.mark.parametrize("pixel", [2, 4, 8, 66, 132, 260, 392, 512, 520, 16384])
def test_k4_pixel_columns_by_multiply_high(pixel):
    """The span sum's pixel column of a byte offset in a map row, the high 64
    bits of offset * ceil(2^64 / P), is offset // P over every offset of a row
    of 4096 pixels (checked at each pixel edge and its neighbours)."""
    magic = (2 ** 64 - 1) // pixel + 1
    edges = [x * pixel + d for x in range(4097) for d in (-1, 0, 1)]
    assert all((off * magic) >> 64 == off // pixel for off in edges if off >= 0)
