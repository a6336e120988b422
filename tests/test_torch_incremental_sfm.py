"""Port parity of the unknown-pose path: the essential-matrix relative pose,
the extrinsics-only refinement (with the D-parameter ``lm_solve``) and the
incremental mapper, on ``tests/synthetic_scenes.py`` scenes on the CPU.

The first five tests mirror ``tests/test_incremental_sfm.py`` on the port
with its thresholds (relative rotation within 1 deg, translation direction
cosine above 0.99, refined translations within 1e-3, ATE below 0.02). The
rest hold the port to the JAX functions on the same inputs and, for RANSAC,
the same samples: the JAX package's draws from its keys are replayed into the
port (``samples=``, ``ransac_pnp_from_samples``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_plus_plus_tpu.eval.trajectory import absolute_trajectory_error, camera_centers_from_poses
from onepose_plus_plus_tpu.geometry import bundle_adjust as jba
from onepose_plus_plus_tpu.geometry.levenberg_marquardt import lm_solve as jax_lm_solve
from onepose_plus_plus_tpu.sfm import incremental as jinc
from onepose_plus_plus_tpu.sfm.coarse_match import merge_keypoints as jax_merge
from onepose_plus_plus_tpu_torch.geometry import bundle_adjust as ba
from onepose_plus_plus_tpu_torch.geometry.levenberg_marquardt import lm_solve
from onepose_plus_plus_tpu_torch.geometry.pnp import ransac_pnp_from_samples
from onepose_plus_plus_tpu_torch.sfm import incremental as inc
from onepose_plus_plus_tpu_torch.sfm.coarse_match import PairMatches, merge_keypoints
from synthetic_scenes import make_scene, project_np
from test_sfm_pipeline import simulate_matcher

torch.set_num_threads(2)


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(np.ascontiguousarray(a if a.dtype == bool else a.astype(np.float32)))


def _rot_err_deg(R, R_ref):
    c = (np.trace(np.asarray(R) @ np.asarray(R_ref).T) - 1) / 2
    return np.rad2deg(np.arccos(np.clip(c, -1, 1)))


def _two_views(seed, outliers=0):
    rng = np.random.default_rng(seed)
    K, pts, Ts = make_scene(rng, n_views=2, n_pts=128)
    uv0, _ = project_np(K, Ts[0], pts)
    uv1, _ = project_np(K, Ts[1], pts)
    if outliers:
        uv1[:outliers] = rng.uniform(0, 512, (outliers, 2))
    else:
        uv1 += rng.normal(0, 0.3, uv1.shape)
    return K, Ts, uv0.astype(np.float32), uv1.astype(np.float32)


def _mapping_scene():
    rng = np.random.default_rng(3)
    K, pts, Ts = make_scene(rng, n_views=6, n_pts=60)
    return K, Ts, simulate_matcher(K, Ts, pts, noise=0.3, seed=3, drop_frac=0.1)


def _ate(poses, Ts):
    est = np.stack([poses[i] for i in range(len(Ts))])
    return absolute_trajectory_error(camera_centers_from_poses(est), camera_centers_from_poses(Ts))["ate_rmse"]


# ------------------------- tests/test_incremental_sfm.py on the port


def test_relative_pose_recovers_up_to_scale():
    K, Ts, uv0, uv1 = _two_views(0)
    gen = torch.Generator().manual_seed(0)
    rel = ba.estimate_relative_pose(_t(uv0), _t(uv1), _t(K), _t(K), torch.ones(128, dtype=torch.bool), gen)
    assert bool(rel.ok) and int(rel.num_inliers) > 100
    T01 = Ts[1] @ np.linalg.inv(Ts[0])
    assert _rot_err_deg(rel.R.numpy(), T01[:3, :3]) < 1.0
    t_gt = T01[:3, 3]
    assert abs(rel.t.numpy() @ t_gt) / np.linalg.norm(t_gt) > 0.99  # direction up to sign


def test_relative_pose_with_outliers():
    K, _, uv0, uv1 = _two_views(1, outliers=40)
    gen = torch.Generator().manual_seed(0)
    rel = ba.estimate_relative_pose(_t(uv0), _t(uv1), _t(K), _t(K), torch.ones(128, dtype=torch.bool), gen,
                                    num_hypotheses=512)
    assert bool(rel.ok)
    inl = rel.inliers.numpy()
    assert inl[40:].mean() > 0.9 and inl[:40].mean() < 0.2


def _perturbed_cameras(seed=2):
    rng = np.random.default_rng(seed)
    K, pts, Ts = make_scene(rng, n_views=4, n_pts=64)
    uvs = np.stack([project_np(K, T, pts)[0] for T in Ts])
    T_pert = Ts.copy()
    for i in range(4):
        T_pert[i, :3, 3] += rng.normal(0, 0.02, 3)
    args = (T_pert, np.tile(K, (4, 1, 1)), np.tile(pts, (4, 1, 1)), uvs, np.ones((4, 64), bool))
    return Ts, [a if a.dtype == bool else a.astype(np.float32) for a in args]


def test_refine_extrinsics_corrects_perturbed_poses():
    Ts, args = _perturbed_cameras()
    T_ref, _ = ba.refine_extrinsics(*map(_t, args))
    for i in range(4):
        assert np.abs(T_ref[i, :3, 3].numpy() - Ts[i][:3, 3]).max() < 1e-3


def test_incremental_maps_synthetic_scene():
    K, Ts, raw = _mapping_scene()
    out = inc.incremental_sfm(merge_keypoints(raw), {i: K for i in range(6)}, min_seed_matches=30,
                              device="cpu")
    assert len(out["registered"]) == 6, out["registered"]
    assert len(out["points"]) > 40
    assert _ate(out["poses"], Ts) < 0.02


def test_unmappable_scene_returns_empty():
    scene = merge_keypoints([PairMatches((0, 1), np.zeros((4, 2)), np.zeros((4, 2)), np.ones(4))])
    out = inc.incremental_sfm(scene, {0: np.eye(3), 1: np.eye(3)}, device="cpu")
    assert out["registered"] == [] and out["points"] == {}


# ------------------------------------------------ against the JAX package


def _jax_relative_pose_samples(key, valid, h=256, s=8):
    """The samples of onepose_plus_plus_tpu/geometry/bundle_adjust.py:161-163."""
    scores = jnp.where(jnp.asarray(valid)[None, :], jax.random.gumbel(key, (h, valid.shape[0])), -jnp.inf)
    return torch.from_numpy(np.array(jax.lax.top_k(scores, s)[1])).long()


def _jax_pnp_samples(key, valid, h=512, s=6, sub=128):
    """The samples of onepose_plus_plus_tpu/geometry/pnp.py:555-607 (as
    tests/test_torch_pnp.py replays them)."""
    n = valid.shape[0]
    scores = jnp.where(jnp.asarray(valid)[None], jax.random.gumbel(key, (h, n)), -jnp.inf)
    idxs = []
    for _ in range(s):
        i = jnp.argmax(scores, axis=-1)
        idxs.append(i)
        scores = jnp.where(jnp.arange(n)[None] == i[:, None], -jnp.inf, scores)
    sample_idx = torch.from_numpy(np.array(jnp.stack(idxs, axis=-1)))[None].long()
    if not sub < n:
        return sample_idx, None
    gs = jnp.where(jnp.asarray(valid), jax.random.gumbel(jax.random.fold_in(key, 1), (n,)), -jnp.inf)
    return sample_idx, torch.from_numpy(np.array(jax.lax.top_k(gs, sub)[1]))[None].long()


@pytest.mark.parametrize("outliers", [0, 40])
def test_relative_pose_matches_jax_on_its_samples(outliers):
    K, _, uv0, uv1 = _two_views(outliers, outliers=outliers)
    valid = np.ones(128, bool)
    key = jax.random.PRNGKey(5)
    ref = jba.estimate_relative_pose(jnp.asarray(uv0), jnp.asarray(uv1), jnp.asarray(K, jnp.float32),
                                     jnp.asarray(K, jnp.float32), jnp.asarray(valid), key)
    got = ba.estimate_relative_pose(_t(uv0), _t(uv1), _t(K), _t(K), _t(valid),
                                    samples=_jax_relative_pose_samples(key, valid))
    assert bool(got.ok) == bool(ref.ok)
    # the same consensus set (measured: equal; one point may sit on the
    # threshold), rotations within 0.05 deg and translation directions within
    # 0.1 deg (measured 0.028 and 0.052 deg: float32 eigensolves of two libraries)
    assert (got.inliers.numpy() != np.asarray(ref.inliers)).sum() <= 1
    assert _rot_err_deg(got.R.numpy(), ref.R) < 0.05
    cos_t = float(got.t.numpy() @ np.asarray(ref.t))
    assert np.rad2deg(np.arccos(min(cos_t, 1.0))) < 0.1


def test_refine_extrinsics_matches_jax():
    """Poses within 1e-4 (measured 6e-8); the costs sit at float32's floor
    (~4e-9 px^2), so they are held only absolutely."""
    _, args = _perturbed_cameras(4)
    T_ref, c_ref = jba.refine_extrinsics(*map(jnp.asarray, args))
    T, c = ba.refine_extrinsics(*map(_t, args))
    np.testing.assert_allclose(T.numpy(), np.asarray(T_ref), atol=1e-4)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), rtol=1e-2, atol=1e-3)


def _cam_problems(seed):
    Ts, (T_pert, K, pts, uv, valid) = _perturbed_cameras(seed)
    valid[:, ::5] = False
    aa = np.stack([np.asarray(jba.matrix_to_angle_axis(jnp.asarray(T[:3, :3]))) for T in T_pert])
    x0 = np.concatenate([aa, T_pert[:, :3, 3]], axis=1).astype(np.float32)
    return x0, (pts, uv, K, valid)


def test_cam_jacobian_closed_form_matches_forward_mode():
    """The closed-form 2M x 6 Jacobian against forward mode through the same
    residual, in float64: 1e-6 relative to the largest entry (measured 6.1e-10)."""
    x0, args = _cam_problems(5)
    x = torch.from_numpy(x0.astype(np.float64))
    targs = [torch.from_numpy(a if a.dtype == bool else a.astype(np.float64)) for a in args]
    r, J = ba._cam_residual_and_jacobian(x, *targs)
    cols = [torch.func.jvp(lambda v: ba._cam_residual(v, *targs), (x,), (torch.eye(6, dtype=x.dtype)[d].expand_as(x),))[1]
            for d in range(6)]
    J_fwd = torch.stack(cols, dim=-1)
    torch.testing.assert_close(r, ba._cam_residual(x, *targs), rtol=0, atol=0)
    assert (J - J_fwd).abs().max() <= 1e-6 * J_fwd.abs().max()


@pytest.mark.parametrize("closed_form", [True, False], ids=["closed_form", "forward_mode"])
def test_lm_solve_matches_jax(closed_form):
    """The batched D-parameter LM against the JAX solver on the camera
    problems: solutions within 1e-4 (measured 6e-8 closed form, 2.4e-7
    forward mode); costs at float32's floor, held absolutely."""
    x0, args = _cam_problems(6)
    ref_x, ref_c = jax_lm_solve(jba._cam_residual, jnp.asarray(x0), tuple(map(jnp.asarray, args)), max_iters=50)

    def residual(x, *a):  # the port's residual without its closed form
        return ba._cam_residual(x, *a)

    fn = ba._cam_residual if closed_form else residual
    x, c = lm_solve(fn, _t(x0), tuple(map(_t, args)), max_iters=50)
    np.testing.assert_allclose(x.numpy(), np.asarray(ref_x), atol=1e-4)
    np.testing.assert_allclose(c.numpy(), np.asarray(ref_c), rtol=1e-2, atol=1e-3)


def test_incremental_sfm_matches_jax_on_its_samples(monkeypatch):
    """Both mappers on the same scene, the port fed the JAX key chain's
    samples: the same registration order, as many points, both trajectories
    within the JAX test's ATE threshold of the truth and of each other."""
    K, Ts, raw = _mapping_scene()
    Ks = {i: K for i in range(6)}
    ref = jinc.incremental_sfm(jax_merge(raw), Ks, min_seed_matches=30)

    keys = [jax.random.PRNGKey(0)]

    def next_key():
        keys[0], sub = jax.random.split(keys[0])
        return sub

    def relative_pose(p0, p1, K0, K1, valid, gen, threshold_px):
        return ba.estimate_relative_pose(p0, p1, K0, K1, valid, threshold_px=threshold_px,
                                         samples=_jax_relative_pose_samples(next_key(), valid.numpy()))

    def pnp(p3, p2, K, valid, gen, reproj_threshold_px):
        sample_idx, sub_idx = _jax_pnp_samples(next_key(), valid[0].numpy())
        return ransac_pnp_from_samples(p3, p2, K, valid, sample_idx, sub_idx,
                                       reproj_threshold_px=reproj_threshold_px)

    monkeypatch.setattr(inc, "estimate_relative_pose", relative_pose)
    monkeypatch.setattr(inc, "ransac_pnp", pnp)
    out = inc.incremental_sfm(merge_keypoints(raw), Ks, min_seed_matches=30, device="cpu")
    assert out["registered"] == ref["registered"]
    assert sorted(out["points"]) == sorted(ref["points"])
    assert _ate(out["poses"], Ts) < 0.02 and _ate(ref["poses"], Ts) < 0.02
    est = np.stack([out["poses"][i] for i in range(6)])
    want = np.stack([ref["poses"][i] for i in range(6)])
    assert absolute_trajectory_error(camera_centers_from_poses(est),
                                     camera_centers_from_poses(want))["ate_rmse"] < 0.02
    for i in range(6):
        assert _rot_err_deg(est[i, :3, :3], want[i, :3, :3]) < 1.0
