"""Port parity: kernel K3's plain version against JAX ``gather_windows_aligned``.

Both are exact copies on the CPU (the JAX one-hot matmul has one non-zero
term per output), so the outputs must be equal, zero windows included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_plus_plus_tpu.ops.window_gather import gather_windows_aligned as jax_gather
from onepose_plus_plus_tpu_torch import kernels
from onepose_plus_plus_tpu_torch.kernels import vector_bytes
from onepose_plus_plus_tpu_torch.ops.cuda_gather import window_gather
from onepose_plus_plus_tpu_torch.ops.window_gather import gather_windows_aligned

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


# The narrow pixels K3 and K4 take with 8-, 4- and 2-byte vectors (bf16 C = 196
# is the sparse FPN's pin map)
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
    (196, torch.bfloat16, 5, 4),   # 8-byte vectors, 49 a pixel
    (130, torch.bfloat16, 5, 4),   # 4-byte vectors, 65 a pixel
    (33, torch.bfloat16, 9, 2),    # 2-byte vectors, 33 a pixel
    (130, torch.float32, 5, 4),    # 8-byte vectors, 65 a pixel
    (33, torch.float32, 5, 4),     # 4-byte vectors, 33 a pixel
    (2, torch.float32, 5, 4),      # 8-byte vectors, one a pixel (a shift)
])
def test_k3_vector_arithmetic_reproduces_the_plain_version(c, dtype, window, stride):
    """K3's index arithmetic (a shift or division per vector, the window row as a
    multiply by ceil(2^20 / W) and a shift) applied to the map's vectors, of the
    width the wrapper picks (16, 8, 4 or 2 bytes), gives the plain version's
    windows exactly: ragged K, corners off the map, ids out of range."""
    from onepose_plus_plus_tpu_torch.ops.cuda_gather import window_gather_plain, window_vector_sources

    grid = (6, 7)
    h, w = stride * grid[0], stride * grid[1]
    rng = np.random.default_rng(3)
    feat = torch.from_numpy(rng.standard_normal((2, h, w, c)).astype(np.float32)).to(dtype)
    ids = torch.from_numpy(rng.integers(-3, 6 * 7 + 3, (2, 13)).astype(np.int32))
    ids[:, :4] = torch.tensor([0, 6, 35, 41], dtype=torch.int32)  # the four corners of the grid
    vec = vector_bytes(c * feat.element_size(), feat.data_ptr())
    nv = c * feat.element_size() // vec
    src = window_vector_sources(ids, (h, w), grid, stride, window, nv)
    vectors = feat.view(torch.uint8).reshape(2, h * w * nv, vec)
    got = torch.stack([torch.where((s >= 0)[..., None], vectors[b][s.clamp_min(0)], 0) for b, s in enumerate(src)])
    ref = window_gather_plain(feat, ids, grid, stride, window)
    assert torch.equal(got.reshape(-1), ref.contiguous().view(torch.uint8).reshape(-1))


def test_k3_rejects_windows_its_arithmetic_does_not_cover():
    from onepose_plus_plus_tpu_torch.ops.cuda_gather import window_vector_sources

    with pytest.raises(ValueError):
        window_vector_sources(torch.zeros(1, 2, dtype=torch.int32), (8, 8), (2, 2), 4, 65, 16)
