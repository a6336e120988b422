"""K6's plain version (``ops/cuda_patch_gather.py::patch_gather_plain``, which
the port's ``gather_windows`` runs on the CPU) against the JAX package's
``gather_patches_dma`` in Pallas interpret mode, as ``tests/test_patch_gather.py``
runs it, and against the XLA ``gather_windows(prefer_dma=False)``. A copy:
exact, in f32 and bf16."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_plus_plus_tpu.ops.pallas_patch_gather import gather_patches_dma
from onepose_plus_plus_tpu.ops.window_gather import gather_windows as jax_gather_windows
from onepose_plus_plus_tpu_torch.ops.cuda_patch_gather import patch_gather, patch_gather_plain
from onepose_plus_plus_tpu_torch.ops.window_gather import gather_windows


def _corners(rng, n, k, h, w, window):
    """Corners inside, across every border, and fully off the map (invalid
    slots come in as row0 <= -W)."""
    r0 = rng.integers(-window - 2, h + 2, (n, k)).astype(np.int32)
    c0 = rng.integers(-window - 2, w + 2, (n, k)).astype(np.int32)
    r0[:, :3] = -10 * window
    c0[:, 3] = w + 4
    return r0, c0


@pytest.mark.parametrize("window", [5, 9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(window, dtype):
    rng = np.random.default_rng(window)
    n, h, w, c, k = 2, 24, 20, 128, 37  # K not a multiple of the block
    feat = rng.standard_normal((n, h, w, c)).astype(np.float32)
    r0, c0 = _corners(rng, n, k, h, w, window)
    jfeat = jnp.asarray(feat, getattr(jnp, dtype))
    want = np.asarray(gather_patches_dma(jfeat, jnp.asarray(r0), jnp.asarray(c0), window,
                                         block_k=8).astype(jnp.float32))
    tfeat = torch.from_numpy(feat).to(getattr(torch, dtype))
    got = patch_gather_plain(tfeat, torch.from_numpy(r0), torch.from_numpy(c0), window)
    assert got.dtype == tfeat.dtype and got.shape == (n, k, window * window, c)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert bool((got[:, :3] == 0).all()) and bool((got[:, 3] == 0).all())


@pytest.mark.parametrize("dtype,c", [("bfloat16", 33), ("bfloat16", 130), ("bfloat16", 196),
                                     ("float32", 33), ("float32", 130)])
def test_plain_matches_pallas_interpret_at_narrow_pixels(dtype, c):
    """Pixels that no 16-byte vector divides (K6's 8-, 4- and 2-byte instances
    on the card; bf16 C = 196 is the sparse FPN's pin map): exact against the
    Pallas kernel, whose lane residue takes any C."""
    rng = np.random.default_rng(c)
    n, h, w, k, window = 2, 13, 11, 19, 9
    feat = rng.standard_normal((n, h, w, c)).astype(np.float32)
    r0, c0 = _corners(rng, n, k, h, w, window)
    jfeat = jnp.asarray(feat, getattr(jnp, dtype))
    want = np.asarray(gather_patches_dma(jfeat, jnp.asarray(r0), jnp.asarray(c0), window,
                                         block_k=8).astype(jnp.float32))
    tfeat = torch.from_numpy(feat).to(getattr(torch, dtype))
    got = patch_gather_plain(tfeat, torch.from_numpy(r0), torch.from_numpy(c0), window)
    assert got.dtype == tfeat.dtype and got.shape == (n, k, window * window, c)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("window", [5, 9])
def test_gather_windows_matches_xla(window):
    rng = np.random.default_rng(10 + window)
    n, h, w, c, k = 2, 17, 23, 32, 29
    feat = rng.standard_normal((n, h, w, c)).astype(np.float32)
    centers = np.stack([rng.integers(-3, h + 3, (n, k)), rng.integers(-3, w + 3, (n, k))],
                       -1).astype(np.int32)
    want = jax_gather_windows(jnp.asarray(feat), jnp.asarray(centers), window, prefer_dma=False)
    got = gather_windows(torch.from_numpy(feat), torch.from_numpy(centers), window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrapper_takes_the_plain_version_on_cpu_only():
    feat = torch.randn(1, 8, 8, 16)
    r0 = torch.tensor([[-2, 3, -40]])
    c0 = torch.tensor([[5, -1, 2]])
    assert torch.equal(patch_gather(feat, r0, c0, 5), patch_gather_plain(feat, r0, c0, 5))
