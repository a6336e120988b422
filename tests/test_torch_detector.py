"""Port parity: the object detector (``inference/detector.py``) against the JAX package.

The affine RANSAC is fed the JAX package's own minimal samples (its Gumbel
top-k from the same key, recomputed here and handed to the port through
``sample_idx``), so both fit the same hypotheses: the fits, inlier sets and
counts agree to f32 least-squares rounding. ``previous_pose_detect`` is the
same numpy code on both sides (exact), the centered fallback too, and
``detect_bbox`` runs a narrow LoFTR ``match_coarse`` with bridged weights on
a block-textured view shifted by whole coarse cells.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_plus_plus_tpu.inference.detector import (
    LocalFeatureObjectDetector as JaxDetector,
    _fit_affine as jax_fit_affine,
    ransac_affine as jax_ransac_affine,
)
from onepose_plus_plus_tpu.models.loftr import LoFTRMatcher as JaxLoFTR
from onepose_plus_plus_tpu_torch.inference.detector import (
    LocalFeatureObjectDetector,
    _fit_affine,
    ransac_affine,
)
from onepose_plus_plus_tpu_torch.models.build import make_loftr_fns
from onepose_plus_plus_tpu_torch.models.loftr import LoFTRMatcher
from onepose_plus_plus_tpu_torch.utils.weights import load_jax_variables
from port_helpers import perturbed, textured, to_port_config
from synthetic_scenes import make_scene
from test_torch_loftr import NARROW as NARROW_LOFTR

pytest.importorskip("cv2")
torch.set_num_threads(2)


def _views(seed, v=3, n=120, n_out=30):
    """Per view a random affine map of n points, the first n_out replaced by outliers."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 400, (v, n, 2)).astype(np.float32)
    A = np.stack([np.array([[1 + 0.2 * rng.standard_normal(), 0.1 * rng.standard_normal(), rng.uniform(-50, 50)],
                            [0.1 * rng.standard_normal(), 1 + 0.2 * rng.standard_normal(), rng.uniform(-50, 50)]])
                  for _ in range(v)])
    dst = (np.einsum("vij,vnj->vni", A[:, :, :2], src) + A[:, None, :, 2]).astype(np.float32)
    dst[:, :n_out] = rng.uniform(0, 400, (v, n_out, 2))
    valid = rng.random((v, n)) > 0.1
    return src, dst, valid, A


def test_fit_affine_matches_jax():
    src, dst, _, _ = _views(0, v=4, n=9, n_out=3)
    ref = np.stack([np.asarray(jax_fit_affine(jnp.asarray(s), jnp.asarray(d))) for s, d in zip(src, dst)])
    got = _fit_affine(torch.from_numpy(src), torch.from_numpy(dst)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("threshold", [2.0, 4.0])
def test_ransac_affine_with_jax_samples_matches_jax(threshold):
    src, dst, valid, A_gt = _views(1)
    v, n = valid.shape
    keys = jax.random.split(jax.random.PRNGKey(0), v)
    idx, ref = [], []
    for i in range(v):
        # the JAX function's own samples for this key (ransac_affine :57-59)
        g = jax.random.gumbel(keys[i], (256, n))
        idx.append(np.asarray(jax.lax.top_k(jnp.where(valid[i][None], g, -jnp.inf), 3)[1]))
        ref.append([np.asarray(r) for r in jax_ransac_affine(
            jnp.asarray(src[i]), jnp.asarray(dst[i]), jnp.asarray(valid[i]), keys[i],
            inlier_threshold_px=threshold)])
    A, inl, cnt = ransac_affine(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(valid),
                                inlier_threshold_px=threshold,
                                sample_idx=torch.from_numpy(np.stack(idx)).long())
    for i in range(v):
        np.testing.assert_allclose(A[i].numpy(), ref[i][0], rtol=1e-4, atol=1e-3)
        np.testing.assert_array_equal(inl[i].numpy(), ref[i][1])
        assert int(cnt[i]) == int(ref[i][2]) >= 70
        np.testing.assert_allclose(A[i].numpy(), A_gt[i], atol=1e-2)
    assert cnt.dtype == torch.int32


def test_ransac_affine_draws_from_its_generator():
    src, dst, valid, A_gt = _views(2)
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(5)
        runs.append(ransac_affine(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(valid), gen,
                                  inlier_threshold_px=2.0))
    for a, b in zip(*runs):
        assert torch.equal(a, b)  # the same seed, the same samples
    np.testing.assert_allclose(runs[0][0].numpy(), A_gt, atol=1e-2)
    assert not runs[0][1][:, :30].any()  # the outliers
    none = ransac_affine(torch.zeros(2, 10, 2), torch.zeros(2, 10, 2), torch.zeros(2, 10, dtype=torch.bool),
                         torch.Generator().manual_seed(0))
    assert none[2].tolist() == [0, 0]


def test_previous_pose_detect_is_exact():
    rng = np.random.default_rng(0)
    K, _, Ts = make_scene(rng, n_views=2, n_pts=8)
    corners = np.array([[x, y, z] for x in (-0.1, 0.1) for y in (-0.1, 0.1) for z in (-0.1, 0.1)])
    query = textured(rng, 1, 512)[0, ..., 0]
    port = LocalFeatureObjectDetector(None, np.zeros((1, 8, 8), np.float32), output_size=256)
    ref = JaxDetector(None, np.zeros((1, 8, 8), np.float32), output_size=256)
    for T in Ts:
        for a, b in zip(port.previous_pose_detect(query, K, T, corners),
                        ref.previous_pose_detect(query, K, T, corners)):
            np.testing.assert_array_equal(a, b)


def test_centered_fallback_without_matches():
    def no_matches(img0, img1, lib):
        v = img0.shape[0]
        return {"mkpts0_c": lib.zeros((v, 8, 2)), "mkpts1_c": lib.zeros((v, 8, 2)),
                "match_mask": lib.zeros((v, 8), dtype=bool)}

    db = np.zeros((2, 64, 64), np.float32)
    query = np.zeros((480, 640), np.float32)
    got = LocalFeatureObjectDetector(lambda a, b: no_matches(a, b, torch), db).detect_bbox(
        query, torch.Generator().manual_seed(0))
    ref = JaxDetector(lambda a, b: no_matches(a, b, jnp), db).detect_bbox(query, jax.random.PRNGKey(0))
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1] == ref[1] == 0
    np.testing.assert_array_equal(got[0], [80, 0, 560, 480])


def test_detect_bbox_on_a_shifted_view_matches_jax():
    """Two DB views (the textured view itself) against the view shifted by
    (16, 8) px, whole coarse cells: both detectors find the translated box."""
    rng = np.random.default_rng(0)
    img0 = textured(rng, 1, 128)
    query = np.roll(img0, (8, 16), axis=(1, 2))[0, ..., 0]
    db = np.concatenate([img0, img0])[..., 0]
    jm = JaxLoFTR(NARROW_LOFTR)
    variables = perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0), img0, img0))
    port = LoFTRMatcher(to_port_config(NARROW_LOFTR)).eval()
    load_jax_variables(port, variables)
    jax_coarse = jax.jit(lambda a, b: jm.apply(variables, a, b, method="match_coarse"))
    got_box, got_n = LocalFeatureObjectDetector(make_loftr_fns(port)[0], db).detect_bbox(
        query, torch.Generator().manual_seed(0))
    ref_box, ref_n = JaxDetector(jax_coarse, db).detect_bbox(query, jax.random.PRNGKey(0))
    assert got_n >= 6 and ref_n >= 6
    np.testing.assert_allclose(got_box, [16, 8, 144, 136], atol=1.0)
    np.testing.assert_allclose(got_box, ref_box, atol=1.0)
    crop, K_crop, box_sq, n = LocalFeatureObjectDetector(make_loftr_fns(port)[0], db, output_size=64).detect(
        query, np.eye(3) * 100, torch.Generator().manual_seed(0))
    assert crop.shape == (64, 64) and n == got_n and box_sq[2] - box_sq[0] == box_sq[3] - box_sq[1]
