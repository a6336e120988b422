"""K6's plain version (``ops/cuda_patch_gather.py::patch_gather_plain``, which
the port's ``gather_windows`` runs on the CPU) against the JAX package's
``gather_patches_dma`` in Pallas interpret mode, as ``tests/test_patch_gather.py``
runs it, and against the XLA ``gather_windows(prefer_dma=False)``. A copy:
exact, in f32 and bf16. Then the kernel's own arithmetic (``patch_spans``,
``patch_chunks``: span copies in 16-byte chunks) applied to a map's bytes,
byte for byte against the plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_plus_plus_tpu.ops.pallas_patch_gather import gather_patches_dma
from onepose_plus_plus_tpu.ops.window_gather import gather_windows as jax_gather_windows
from onepose_plus_plus_tpu_torch.ops.cuda_patch_gather import (
    chunk_slots,
    patch_chunks,
    patch_gather,
    patch_gather_centered,
    patch_gather_plain,
    patch_spans,
)
from onepose_plus_plus_tpu_torch.ops.window_gather import gather_windows
from port_helpers import run_span_chunks


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


# every vector width the old wrapper could pick: pixels of 2 to 392 bytes
PLAN_PIXELS = [("bfloat16", c) for c in (1, 2, 4, 8, 33, 130, 196)] + [("float32", c) for c in (1, 2, 4, 33, 65)]


@pytest.mark.parametrize("base", [0, 2, 4, 8])
@pytest.mark.parametrize("window", [5, 9, 13])
@pytest.mark.parametrize("dtype,c", PLAN_PIXELS)
def test_k6_span_plan_reproduces_the_plain_version(dtype, c, window, base):
    """The kernel's span plan, applied to the map's bytes in an allocation
    where the map starts ``base`` bytes past a 16-byte alignment (a view into
    a larger buffer), equals the plain version byte for byte: corners across
    each edge, fully off the map (-10 * window, as ``fine_windows`` makes
    them), inside, and windows wider than the map. No fetch leaves the
    allocation, and the rows' spans add up."""
    rng = np.random.default_rng(1000 * c + 10 * window + base)
    n, h, w, k = 2, 13, 11, 12
    feat = torch.from_numpy(rng.standard_normal((n, h, w, c)).astype(np.float32)).to(getattr(torch, dtype))
    r0, c0 = _corners(rng, n, k, h, w, window)
    r0[:, 4], c0[:, 5] = h - 1, w - 1  # one tap row / column on the map
    r0[:, 6], c0[:, 6] = 2, 1  # inside (or as far inside as a wide window goes)
    r0, c0 = torch.from_numpy(r0), torch.from_numpy(c0)
    want = patch_gather_plain(feat, r0, c0, window)
    pixel = c * feat.element_size()
    map_bytes = feat.numel() * feat.element_size()
    alloc = torch.from_numpy(rng.integers(0, 256, -(-(base + map_bytes) // 16) * 16).astype(np.uint8))
    alloc[base:base + map_bytes] = feat.reshape(-1).view(torch.uint8)
    spans = patch_spans(r0, c0, (h, w), pixel, window, feat_addr=base)
    row = window * pixel
    assert torch.equal(spans["head"] + spans["length"] + spans["tail"], torch.full_like(spans["head"], row))
    copied = spans["length"] > 0
    for key in ("fetch_lo", "fetch_hi"):
        f = spans[key][copied]
        assert bool((f % 16 == 0).all()) and bool((f >= 0).all()) and bool((f <= alloc.numel()).all())
    assert bool((spans["fetch_lo"] <= spans["src"])[copied].all())
    assert bool((spans["src"] + spans["length"] <= spans["fetch_hi"])[copied].all())
    assert torch.equal(spans["shift"][copied], (spans["src"] - spans["dst"] - spans["head"])[copied] % 16)
    got = run_span_chunks(alloc, base, base + map_bytes, patch_chunks(spans, pixel, window), want.numel() * want.element_size())
    assert torch.equal(got, want.reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("pixel,window,feat_addr,out_addr", [
    (256, 0, 0, 0),  # no window
    (256, 256, 0, 0),  # wider than the kernel's 255
    (3, 9, 0, 0),  # a pixel that is not whole 2-byte halves
    (256, 9, 1, 0),  # a map at an odd address
    (256, 9, 0, 8),  # an output off its 16-byte alignment
    (1 << 25, 9, 0, 0),  # a patch of 2^31 bytes or more
    (1 << 20, 255, 0, 0),  # rows too long for the slot arithmetic
])
def test_k6_span_plan_rejects_what_the_kernel_does_not_cover(pixel, window, feat_addr, out_addr):
    r0 = torch.zeros(1, 3, dtype=torch.int32)
    with pytest.raises(ValueError):
        patch_spans(r0, r0, (8, 8), pixel, window, feat_addr=feat_addr, out_addr=out_addr)


@pytest.mark.parametrize("pixel,window", [(256, 9), (66, 9), (392, 9), (2, 5), (260, 13), (16384, 9), (1024, 255)])
def test_k6_chunk_slots_cover_every_row(pixel, window):
    """A patch row of window * pixel bytes gets the most 16-byte chunks any row
    of a 16-byte aligned output touches, and the slot-to-row multiply is exact
    over the patch's slots."""
    row = window * pixel
    touched = max(-(-(start % 16 + row) // 16) for start in range(0, 16 * row, row))
    cmax, magic = chunk_slots(pixel, window)
    assert cmax == touched
    t = torch.arange(window * cmax)
    assert torch.equal((t * magic) >> 48, t // cmax)


@pytest.mark.parametrize("dtype,c", [("bfloat16", 33), ("float32", 128)])
def test_k6_span_plan_matches_pallas_interpret(dtype, c):
    """The span plan against the JAX kernel itself (interpret mode), at a map
    4 bytes past an alignment."""
    rng = np.random.default_rng(c)
    n, h, w, k, window = 2, 13, 11, 19, 9
    feat = rng.standard_normal((n, h, w, c)).astype(np.float32)
    r0, c0 = _corners(rng, n, k, h, w, window)
    jfeat = jnp.asarray(feat, getattr(jnp, dtype))
    want = gather_patches_dma(jfeat, jnp.asarray(r0), jnp.asarray(c0), window, block_k=8)
    tfeat = torch.from_numpy(feat).to(getattr(torch, dtype))
    pixel, map_bytes = c * tfeat.element_size(), tfeat.numel() * tfeat.element_size()
    alloc = torch.zeros(-(-(4 + map_bytes) // 16) * 16, dtype=torch.uint8)
    alloc[4:4 + map_bytes] = tfeat.reshape(-1).view(torch.uint8)
    spans = patch_spans(torch.from_numpy(r0), torch.from_numpy(c0), (h, w), pixel, window, feat_addr=4)
    out_bytes = n * k * window * window * pixel
    got = run_span_chunks(alloc, 4, 4 + map_bytes, patch_chunks(spans, pixel, window), out_bytes)
    got = got.view(tfeat.dtype).reshape(n, k, window * window, c)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_centered_gather_is_the_corner_gather_at_minus_half():
    rng = np.random.default_rng(3)
    feat = torch.from_numpy(rng.standard_normal((2, 9, 10, 6)).astype(np.float32))
    centers = torch.from_numpy(rng.integers(-6, 16, (2, 7, 2)))
    want = patch_gather_plain(feat, centers[..., 0] - 4, centers[..., 1] - 4, 9)
    assert torch.equal(patch_gather_centered(feat, centers, 9), want)
    assert torch.equal(gather_windows(feat, centers, 9), want)
