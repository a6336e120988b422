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


@pytest.mark.parametrize("c", [384, 512, 640, 1024, 4096])
def test_k5_plain_matches_jax_above_256_channels(c):
    """The widths the wide instances take (the resident tile in 256-channel
    chunks up to 576, the channel-streaming tile and clusters of 256-channel
    slices above), at small P and L."""
    feat0, feat1, gt = _inputs(1, 80, 72, c, seed=c)
    ref_loss, ref_mx, ref_g = _jax(feat0, feat1, gt, 0.08, 2.0)
    loss, mx, g = _port(feat0, feat1, gt, 0.08, 2.0)
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, ref_loss, rtol=2e-4)
    np.testing.assert_allclose(mx, ref_mx, rtol=2e-4)
    _assert_grads_close(g, ref_g)


def test_k5_width_rule():
    """Which instance each coarse width takes on the card: the resident tile up
    to 576 channels (the packed tile's widest), its feature gradients in one
    block per 256 padded channels; the wide instance up to 4096 (K1's widest),
    its feature gradients in a thread-block cluster of one block per 256
    channels of C padded to 64 (at most 16, the H100's non-portable cluster);
    past that a refusal that names K1's ceiling."""
    from onepose_plus_plus_tpu_torch.ops.cuda_coarse_loss import k5_instance
    from onepose_plus_plus_tpu_torch.ops.cuda_encoder import k1_instance
    from onepose_plus_plus_tpu_torch.ops.cuda_matching import TC_MAX_CHANNELS

    for c in range(64, 4097, 16):
        instance, blocks = k5_instance(c)
        if c <= TC_MAX_CHANNELS:
            assert instance == "tc" and blocks == -(-c // 256), c
        else:
            assert instance == "wide" and blocks == -(-(-(-c // 64) * 64) // 256), c
            assert 3 <= blocks <= 16, c
    assert k5_instance(256) == ("tc", 1) and k5_instance(257) == ("tc", 2)  # 257 pads to 272
    assert k5_instance(576) == ("tc", 3) and k5_instance(577) == ("wide", 3)
    assert k5_instance(640) == ("wide", 3) and k5_instance(1024) == ("wide", 4)
    assert k5_instance(2048) == ("wide", 8) and k5_instance(2049) == ("wide", 9)  # past 8: non-portable
    assert k5_instance(4000) == ("wide", 16) and k5_instance(4096) == ("wide", 16)
    assert k1_instance(4096, 8, torch.float32) is not None  # K1 runs the widest K5 width
    for c in (4097, 8192):
        assert k1_instance(c, 8, torch.float32) is None
        with pytest.raises(ValueError, match="4096"):
            k5_instance(c)


@pytest.mark.parametrize("c", [577, 600, 640, 700, 1000, 1024, 2047, 2048, 4000, 4096])
def test_k5_wide_slices_cover_the_padded_channels_once(c):
    """The wide instance's cluster: block j holds [256 j, 256 j + w) of C padded
    to 64, every slice a whole number of 64-channel chunks, the last one 64,
    128, 192 or 256 wide; the slices cover the padded width once, in rank order."""
    from onepose_plus_plus_tpu_torch.ops.cuda_coarse_loss import k5_instance, wide_slices

    slices = wide_slices(c)
    cp = -(-c // 64) * 64
    assert len(slices) == k5_instance(c)[1]
    assert [c0 for c0, _ in slices] == list(range(0, cp, 256))
    assert sum(w for _, w in slices) == cp and all(w % 64 == 0 and 0 < w <= 256 for _, w in slices)
    assert all(w == 256 for _, w in slices[:-1])
    with pytest.raises(ValueError):
        wide_slices(576)


def _emulated_feature_grads(f0, f1, gt, inv_temp, coefs, alpha=0.5, gamma=2.0, slices=None):
    """df0, df1 in the TPU kernel's arithmetic, in PyTorch (``_dfeat_kernel``
    and ``_core_bwd``): s = f0 f1^T * inv_temp in f32 over the bf16 operands
    (with ``slices``, as the sum of each slice's partial product in their
    order: the wide instance's cluster); the LSEs, g = dL/dlogconf and its row
    and column sums from it; dsim = (2 g - softmax_p * colsum(g) - softmax_l *
    rowsum(g)) * inv_temp rounded to bf16; the two products in f32; each df
    rounded to bf16. Returns f32 tensors holding bf16 values (before the
    operands' scale)."""
    from onepose_plus_plus_tpu_torch.ops.cuda_coarse_loss import LOGCAP

    a0, a1 = f0.float(), f1.float()
    s = None
    for c0, w in slices or [(0, a0.shape[-1])]:
        part = torch.einsum("bpc,blc->bpl", a0[..., c0:c0 + w], a1[..., c0:c0 + w])
        s = part if s is None else s + part
    s = s * inv_temp
    row_lse, col_lse = torch.logsumexp(s, dim=2, keepdim=True), torch.logsumexp(s, dim=1, keepdim=True)
    raw = 2.0 * s - col_lse - row_lse
    conf = torch.exp(torch.clamp(raw, max=LOGCAP))
    is_pos = gt.long()[:, :, None] == torch.arange(a1.shape[1])
    om = 1.0 - conf
    dpos = gamma * conf * om ** (gamma - 1) * raw - om ** gamma
    dneg = gamma * conf ** gamma * (-torch.log1p(-conf)) + conf ** gamma * conf / om
    g = torch.where(is_pos, coefs[0] * alpha * dpos, coefs[1] * (1 - alpha) * dneg)
    g = torch.where(raw < LOGCAP, g, torch.zeros_like(g))
    sm_p, sm_l = torch.exp(s - col_lse), torch.exp(s - row_lse)
    dsim = ((2.0 * g - sm_p * g.sum(1, keepdim=True) - sm_l * g.sum(2, keepdim=True)) * inv_temp)
    dsim = dsim.to(torch.bfloat16).float()
    df0, df1 = torch.einsum("bpl,blc->bpc", dsim, a1), torch.einsum("bpl,bpc->blc", dsim, a0)
    return df0.to(torch.bfloat16).float(), df1.to(torch.bfloat16).float()


def _cluster_feature_grads(f0, f1, gt, inv_temp, coefs, alpha=0.5, gamma=2.0):
    """df0, df1 in the wide instance's arithmetic, in PyTorch: s as the sum of
    each block's partial product over its channel slice, in rank order; dsim
    formed once from it (the plain version's formula of dL/ds), rounded to
    bf16; the products in f32; each df rounded to bf16 as the blocks store it.
    The LSEs and g sums from the plain forward."""
    from onepose_plus_plus_tpu_torch.ops.cuda_coarse_loss import wide_slices

    return _emulated_feature_grads(f0, f1, gt, inv_temp, coefs, alpha, gamma, slices=wide_slices(f0.shape[-1]))


def _rounding_distance(got, ref):
    """(share of elements that differ, largest |got - ref| in units of
    2^-7 |ref| (one bf16 step of ref is at most that), mean |got - ref| as a
    share of max|ref|): two gradients that round their dsim and df to bf16
    alike differ only where an f32 difference in the order of sums tips a
    rounding to the neighbouring bf16 value."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    d = np.abs(got - ref)
    steps = (d / np.maximum(2.0 ** -7 * np.abs(ref), 1e-30)).max()
    return float((d > 0).mean()), float(steps), float(d.mean() / np.abs(ref).max())


@pytest.mark.parametrize("b,p,l,c", [(2, 70, 130, 640), (1, 65, 129, 1000), (1, 40, 33, 4000)])
def test_k5_cluster_arithmetic_matches_the_plain_gradients(b, p, l, c):
    """The wide feature gradients' order of work (partial similarities summed
    over the slices in rank order, each dsim formed once and rounded to bf16,
    then the products) against the plain version's autograd, at the card
    tests' tolerances (2e-2 of max|grad|, cosine > 0.999)."""
    from onepose_plus_plus_tpu_torch.ops.cuda_coarse_loss import coarse_focal_sums_plain

    feat0, feat1, gt = _inputs(b, p, l, c, seed=c)
    f0 = torch.from_numpy(feat0 / c ** 0.5).to(torch.bfloat16)
    f1 = torch.from_numpy(feat1 / c ** 0.5).to(torch.bfloat16)
    gt = torch.from_numpy(gt)
    coefs, inv_temp = (0.7, 1.3), 1.0 / (0.08 + 1e-4)
    a0, a1 = f0.clone().requires_grad_(), f1.clone().requires_grad_()
    pos, neg, _ = coarse_focal_sums_plain(a0, a1, gt, inv_temp, 0.5, 2.0)
    (coefs[0] * pos + coefs[1] * neg).backward()
    got = _cluster_feature_grads(f0, f1, gt, inv_temp, coefs)
    _assert_grads_close([x.numpy() for x in got], [a0.grad.float().numpy(), a1.grad.float().numpy()])


def _flips_bounded(got, ref, share, mean):
    for g, r in zip(got, ref):
        differ, _, mean_d = _rounding_distance(g, r)
        assert differ <= share and mean_d <= mean, (differ, mean_d)


def test_k5_plain_gradients_round_as_jax_does():
    """The plain version's feature gradients round dsim and df to bf16 where
    the TPU kernel does, so they equal JAX's (interpret mode) but where an f32
    sum in another order tips one rounding to the neighbouring bf16 value: at
    most 1 % of the elements differ and the mean |difference| stays within
    1e-6 of max|grad| (measured: 8.1e-4 / 9.8e-5 of the elements, 1.9e-8 /
    1.6e-8). A path that rounds only df, or only dsim, misses both bounds by
    far (one that keeps dsim in f32: 41 % / 40 % of the elements, 9.6e-5 /
    1.3e-4); no element is more than one bf16 step of max|grad| off."""
    feat0, feat1, gt = _inputs(1, 300, 160, 640, seed=640)
    _, _, ref = _jax(feat0, feat1, gt, 0.08, 2.0)
    _, _, got = _port(feat0, feat1, gt, 0.08, 2.0)
    _flips_bounded(got, ref, share=1e-2, mean=1e-6)
    for g, r in zip(got, ref):
        assert np.abs(g - r).max() <= 2.0 ** -7 * np.abs(r).max()


@pytest.mark.parametrize("feat_norm", ["sqrt_feat_dim", "none"])
@pytest.mark.parametrize("c", [256, 640, 1024])
def test_k5_plain_gradients_follow_the_dfeat_arithmetic(c, feat_norm):
    """The plain version's feature gradients (autograd of the dense path, its
    similarity's backward rounding dsim and df) against the TPU kernel's
    arithmetic written out (:func:`_emulated_feature_grads`: dsim from the
    LSEs and g sums, rounded to bf16, f32 products, df rounded to bf16, times
    the operands' scale) on the same inputs. The two form dsim by different
    f32 sums, so a rounding may tip: at most 1 % of the elements differ and
    the mean |difference| stays within 1e-7 of max|grad| (measured at most
    7.6e-4 of the elements and 1.0e-8 at C = 1024, none at 256 and 640)."""
    from onepose_plus_plus_tpu_torch.ops.cuda_coarse_loss import fused_coarse_focal_loss as port_loss

    b, p, l = 1, 200, 130
    feat0, feat1, gt = _inputs(b, p, l, c, seed=c + 1)
    if feat_norm == "none":  # the same magnitudes of s without the scale
        feat0, feat1 = feat0 / c ** 0.5, feat1 / c ** 0.5
    scale = c ** -0.5 if feat_norm == "sqrt_feat_dim" else 1.0
    f0 = torch.from_numpy(feat0).requires_grad_()
    f1 = torch.from_numpy(feat1).requires_grad_()
    loss, _ = port_loss(f0, f1, torch.from_numpy(gt), 0.08, feat_norm=feat_norm)
    loss.backward()
    n_pos = int((gt >= 0).sum())
    coefs = (1.0 / max(n_pos, 1), 1.0 / (b * p * l - n_pos))  # the loss's count normalisation
    a0, a1 = ((torch.from_numpy(f) * scale).to(torch.bfloat16) for f in (feat0, feat1))
    emu = _emulated_feature_grads(a0, a1, torch.from_numpy(gt), 1.0 / (0.08 + 1e-4), coefs)
    _flips_bounded([f0.grad.numpy(), f1.grad.numpy()], [(e * scale).numpy() for e in emu], share=1e-2, mean=1e-7)
