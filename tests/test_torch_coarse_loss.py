"""K5's plain version against the JAX package's fused coarse focal loss.

``ops/cuda_coarse_loss.py::fused_coarse_focal_loss`` on CPU tensors runs the
dense log-space path on the same bf16-rounded, scaled features as the kernel;
the JAX side is ``pallas_coarse_loss.fused_coarse_focal_loss`` in interpret
mode, as ``tests/test_pallas_coarse_loss.py`` runs it. Bounds are that file's:
loss and max_conf rtol 2e-4; gradients max error < 2e-2 of the largest
gradient and cosine > 0.999 (the TPU kernel rounds dL/ds to bf16 before its
products, the plain version keeps f32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_plus_plus_tpu.ops.pallas_coarse_loss import fused_coarse_focal_loss as jax_fused_loss
from onepose_plus_plus_tpu_torch.ops.cuda_coarse_loss import fused_coarse_focal_loss


def _inputs(b, p, l, c, seed=0, frac_pos=0.3):
    rng = np.random.default_rng(seed)
    feat0 = rng.standard_normal((b, p, c)).astype(np.float32)
    feat1 = rng.standard_normal((b, l, c)).astype(np.float32)
    gt = np.where(rng.random((b, p)) < frac_pos, rng.integers(0, l, (b, p)), -1).astype(np.int32)
    return feat0, feat1, gt


def _jax(feat0, feat1, gt, t, gamma):
    def f(a, b):
        return jax_fused_loss(a, b, jnp.asarray(gt), t, 0.5, gamma, 1.0, 1.0,
                              tiles=(128, 128), interpret=True)
    (loss, mx), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(feat0), jnp.asarray(feat1))
    return float(loss), float(mx), [np.asarray(g) for g in grads]


def _port(feat0, feat1, gt, t, gamma):
    f0 = torch.from_numpy(feat0).requires_grad_()
    f1 = torch.from_numpy(feat1).requires_grad_()
    loss, mx = fused_coarse_focal_loss(f0, f1, torch.from_numpy(gt), t, 0.5, gamma, 1.0, 1.0)
    loss.backward()
    assert not mx.requires_grad
    return float(loss.detach()), float(mx), [f0.grad.numpy(), f1.grad.numpy()]


def _assert_grads_close(got, ref):
    for g, r in zip(got, ref):
        scale = np.abs(r).max()
        assert scale > 0
        assert np.abs(g - r).max() < 2e-2 * scale
        cos = (g * r).sum() / (np.linalg.norm(g) * np.linalg.norm(r) + 1e-12)
        assert cos > 0.999


@pytest.mark.parametrize(
    "b,p,l,gamma,frac_pos",
    [
        (2, 96, 64, 2.0, 0.3),  # one tile, unaligned shapes
        (1, 300, 160, 2.0, 0.3),  # several row and column tiles
        (1, 96, 64, 2.5, 0.3),  # general gamma
        (1, 96, 64, 2.0, 0.0),  # no positives
    ],
)
def test_k5_plain_matches_jax(b, p, l, gamma, frac_pos):
    feat0, feat1, gt = _inputs(b, p, l, 32, seed=p + l, frac_pos=frac_pos)
    assert (frac_pos > 0) == bool((gt >= 0).any())
    ref_loss, ref_mx, ref_g = _jax(feat0, feat1, gt, 0.08, gamma)
    loss, mx, g = _port(feat0, feat1, gt, 0.08, gamma)
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, ref_loss, rtol=2e-4)
    np.testing.assert_allclose(mx, ref_mx, rtol=2e-4)
    _assert_grads_close(g, ref_g)


@pytest.mark.parametrize("scale", [32 ** -0.5, 1.0])
def test_k5_core_scales_and_rounds_its_operands_on_the_cpu(scale):
    """coarse_focal_sums(f0, f1, ..., scale) on f32 features is the plain
    version of (f0 * scale) and (f1 * scale) rounded to bf16, with the
    gradients carried back through the scale and the rounding."""
    from onepose_plus_plus_tpu_torch.ops.cuda_coarse_loss import coarse_focal_sums, coarse_focal_sums_plain

    feat0, feat1, gt = _inputs(2, 96, 64, 32, seed=5)
    gt = torch.from_numpy(gt)
    runs = []
    for fused in (True, False):
        f0 = torch.from_numpy(feat0).requires_grad_()
        f1 = torch.from_numpy(feat1).requires_grad_()
        if fused:
            pos, neg, mx = coarse_focal_sums(f0, f1, gt, 12.5, 0.5, 2.0, scale)
        else:
            pos, neg, mx = coarse_focal_sums_plain((f0 * scale).to(torch.bfloat16),
                                                   (f1 * scale).to(torch.bfloat16), gt, 12.5, 0.5, 2.0)
        (0.7 * pos + 1.3 * neg).backward()
        runs.append((pos.detach(), neg.detach(), mx, f0.grad, f1.grad))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("c", [384, 512, 640])
def test_k5_plain_matches_jax_above_256_channels(c):
    """The widths the wide instances take (tensor cores in 256-channel chunks
    up to 576, CUDA cores above), at small P and L."""
    feat0, feat1, gt = _inputs(1, 80, 72, c, seed=c)
    ref_loss, ref_mx, ref_g = _jax(feat0, feat1, gt, 0.08, 2.0)
    loss, mx, g = _port(feat0, feat1, gt, 0.08, 2.0)
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, ref_loss, rtol=2e-4)
    np.testing.assert_allclose(mx, ref_mx, rtol=2e-4)
    _assert_grads_close(g, ref_g)


def test_k5_width_rule():
    """Which instance each coarse width takes on the card: the tensor cores up
    to 576 channels (the packed tile's widest), their feature gradients in one
    block per 256 padded channels; the CUDA cores up to 4096 (K1's widest);
    past that a refusal that names K1's ceiling."""
    from onepose_plus_plus_tpu_torch.ops.cuda_coarse_loss import k5_instance
    from onepose_plus_plus_tpu_torch.ops.cuda_encoder import k1_instance
    from onepose_plus_plus_tpu_torch.ops.cuda_matching import TC_MAX_CHANNELS

    for c in range(64, 4097, 16):
        instance, chunks = k5_instance(c)
        if c <= TC_MAX_CHANNELS:
            assert instance == "tc" and chunks == -(-c // 256), c
        else:
            assert (instance, chunks) == ("cuda_cores", 1), c
    assert k5_instance(256) == ("tc", 1) and k5_instance(257) == ("tc", 2)  # 257 pads to 272
    assert k5_instance(576) == ("tc", 3) and k5_instance(577) == ("cuda_cores", 1)
    assert k5_instance(4096) == ("cuda_cores", 1)
    assert k1_instance(4096, 8, torch.float32) is not None  # K1 runs the widest K5 width
    for c in (4097, 8192):
        assert k1_instance(c, 8, torch.float32) is None
        with pytest.raises(ValueError, match="4096"):
            k5_instance(c)
