"""Port parity: kernel K3's plain version against JAX ``gather_windows_aligned``.

Both are exact copies on the CPU (the JAX one-hot matmul has one non-zero
term per output), so the outputs must be equal, zero windows included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_plus_plus_tpu.ops.window_gather import gather_windows_aligned as jax_gather
from onepose_plus_plus_tpu_torch import kernels
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


def test_cpu_tensors_never_launch_the_kernel():
    kernels.reset_launch_counts()
    feat = torch.zeros(1, 8, 8, 16)
    window_gather(feat, torch.zeros(1, 3, dtype=torch.int32), (2, 2), 4, 5)
    assert kernels.launch_counts()["K3_window_gather"] == 0


def test_rejects_map_not_matching_grid():
    with pytest.raises(ValueError):
        gather_windows_aligned(torch.zeros(1, 10, 8, 4), torch.zeros(1, 2), (2, 2), 4, 5)
