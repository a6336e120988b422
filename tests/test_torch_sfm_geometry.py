"""Port parity: the SfM geometry (rotations, epipolar verification,
triangulation, the depth residual and its two solvers) against the JAX
package on ``tests/synthetic_scenes.py`` inputs, both in float32 on the CPU.

Tolerances: closed forms (rotations, residuals, epipolar distances) 1e-5
relative; triangulated points 1e-3 (a 4 x 4 eigensolve in float32 on two
libraries), their masks equal; solved depths 1e-4 relative (20 LM or a few
hundred Adam iterations in float32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_plus_plus_tpu.geometry import epipolar as jep
from onepose_plus_plus_tpu.geometry import rotations as jrot
from onepose_plus_plus_tpu.geometry.levenberg_marquardt import (
    first_order_solve as jax_first_order,
    lm_solve_scalar as jax_lm_scalar,
)
from onepose_plus_plus_tpu.geometry.residuals import depth_residual_track as jax_residual
from onepose_plus_plus_tpu.geometry.triangulation import triangulate_and_filter as jax_triangulate
from onepose_plus_plus_tpu.sfm.post_optimization import optimize_depths as jax_optimize_depths
from onepose_plus_plus_tpu_torch.geometry import rotations as rot
from onepose_plus_plus_tpu_torch.geometry.epipolar import (
    epipolar_error,
    fundamental_from_poses,
    verify_matches,
)
from onepose_plus_plus_tpu_torch.geometry import levenberg_marquardt
from onepose_plus_plus_tpu_torch.geometry.levenberg_marquardt import first_order_solve, lm_solve_scalar
from onepose_plus_plus_tpu_torch.geometry.residuals import depth_residual_and_derivative, depth_residual_track
from onepose_plus_plus_tpu_torch.sfm.post_optimization import optimize_depths
from onepose_plus_plus_tpu_torch.geometry.triangulation import triangulate_and_filter
from synthetic_scenes import make_scene, project_np


def _t(a):
    return torch.from_numpy(np.array(a, bool if np.asarray(a).dtype == bool else np.float32))


def _rotations(rng, n):
    """Random rotations plus the log map's hard cases: identity, near-identity,
    half turns and near half turns."""
    aa = rng.standard_normal((n, 3))
    aa = aa / np.linalg.norm(aa, axis=1, keepdims=True) * rng.uniform(0, np.pi, (n, 1))
    aa[0] = 0.0
    aa[1] = [1e-6, -2e-6, 0.0]
    aa[2] = [np.pi, 0, 0]
    aa[3] = np.array([0.3, -0.5, 0.8]) / np.linalg.norm([0.3, -0.5, 0.8]) * (np.pi - 1e-4)
    return np.asarray(jrot.angle_axis_to_matrix(jnp.asarray(aa, jnp.float32)))


def test_rotations_match_jax():
    rng = np.random.default_rng(0)
    R = _rotations(rng, 64)
    q_ref = np.asarray(jrot.matrix_to_qvec(jnp.asarray(R)))
    q = rot.matrix_to_qvec(_t(R)).numpy()
    np.testing.assert_allclose(q, q_ref, atol=1e-5)
    aa_ref = np.asarray(jrot.matrix_to_angle_axis(jnp.asarray(R)))
    aa = rot.matrix_to_angle_axis(_t(R)).numpy()
    # at a half turn +axis and -axis are the same rotation; compare the matrices there
    np.testing.assert_allclose(aa[4:], aa_ref[4:], atol=1e-4)
    np.testing.assert_allclose(rot.angle_axis_to_matrix(_t(aa)).numpy(), R, atol=1e-5)
    np.testing.assert_allclose(rot.qvec_to_matrix(_t(q_ref)).numpy(),
                               np.asarray(jrot.qvec_to_matrix(jnp.asarray(q_ref))), atol=1e-6)
    pts = rng.standard_normal((64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        rot.angle_axis_rotate_point(_t(aa_ref), _t(pts)).numpy(),
        np.asarray(jrot.angle_axis_rotate_point(jnp.asarray(aa_ref), jnp.asarray(pts))), atol=1e-5)


def test_verify_matches_matches_jax():
    rng = np.random.default_rng(1)
    K, pts, Ts = make_scene(rng, n_views=4, n_pts=80)
    b, n = 3, 80
    args = {k: [] for k in ("K0", "K1", "T0", "T1", "p0", "p1", "valid")}
    for i in range(b):
        uv0, _ = project_np(K, Ts[i], pts)
        uv1, _ = project_np(K, Ts[i + 1], pts)
        uv1 = uv1 + rng.normal(0, 1.0, uv1.shape)
        uv1[::5] += rng.uniform(10, 40, (len(uv1[::5]), 2))  # outliers
        valid = np.arange(n) < n - 7 * i  # padded slots
        for k, v in zip(args, (K, K, Ts[i], Ts[i + 1], uv0, uv1, valid)):
            args[k].append(v)
    arrs = [np.stack(v).astype(bool if k == "valid" else np.float32) for k, v in args.items()]
    ref = np.asarray(jep.verify_matches(*map(jnp.asarray, arrs), max_error_px=4.0))
    got = verify_matches(*map(_t, arrs), max_error_px=4.0).numpy()
    F = fundamental_from_poses(*map(_t, arrs[:4]))
    F_ref = jep.fundamental_from_poses(*map(jnp.asarray, arrs[:4]))
    err = epipolar_error(F, _t(arrs[4]), _t(arrs[5])).numpy()
    err_ref = np.asarray(jep.epipolar_error(F_ref, jnp.asarray(arrs[4]), jnp.asarray(arrs[5])))
    np.testing.assert_allclose(err, err_ref, rtol=1e-4, atol=1e-4)
    clear = np.abs(err_ref - 4.0) > 1e-3  # no distance on the threshold itself
    np.testing.assert_array_equal(got[clear], ref[clear])
    assert got.sum() > 0 and not got[~arrs[6]].any()


def _tracks(rng, n_tracks=40, v=6, noise=0.5):
    K, pts, Ts = make_scene(rng, n_views=v, n_pts=n_tracks)
    uv = np.stack([project_np(K, Ts[j], pts)[0] for j in range(v)], axis=1)
    uv = uv + rng.normal(0, noise, uv.shape)
    uv[::7, 1] += 60.0  # an outlier observation
    valid = np.ones((n_tracks, v), bool)
    valid[::3, 4:] = False  # short tracks (padding)
    valid[5, 1:] = False  # a single observation: never ok
    Kt = np.broadcast_to(K, (n_tracks, v, 3, 3)).astype(np.float32)
    Tt = np.broadcast_to(Ts[None], (n_tracks, v, 4, 4)).astype(np.float32)
    return Kt, Tt, uv.astype(np.float32), valid, pts


@pytest.mark.parametrize("eigh_chunk", [None, 7])
def test_triangulate_and_filter_matches_jax(eigh_chunk, monkeypatch):
    """Also with the batched eigensolves split into chunks of 7 matrices."""
    if eigh_chunk is not None:
        from onepose_plus_plus_tpu_torch.geometry import triangulation

        monkeypatch.setattr(triangulation, "EIGH_CHUNK", eigh_chunk)
    Kt, Tt, uv, valid, pts = _tracks(np.random.default_rng(2))
    ref = [np.asarray(a) for a in jax_triangulate(*map(jnp.asarray, (Kt, Tt, uv, valid)))]
    got = [a.numpy() for a in triangulate_and_filter(*map(_t, (Kt, Tt, uv, valid)))]
    names = ("xyz", "obs_inlier", "track_ok", "reproj_err")
    np.testing.assert_array_equal(got[2], ref[2], err_msg="track_ok")
    np.testing.assert_array_equal(got[1], ref[1], err_msg="obs_inlier")
    ok = ref[2]
    np.testing.assert_allclose(got[0][ok], ref[0][ok], atol=1e-3, err_msg=names[0])
    np.testing.assert_allclose(got[3][ref[1]], ref[3][ref[1]], atol=1e-3, err_msg=names[3])
    assert ok.sum() > 20 and not ok[5]
    np.testing.assert_allclose(got[0][ok], pts[ok], atol=2e-2)  # and near the truth


def _depth_problems(rng, n=32, v=3):
    K, pts, Ts = make_scene(rng, n_views=v + 1, n_pts=n)
    uv0, depth = project_np(K, Ts[0], pts)
    aa = np.stack([np.asarray(jrot.matrix_to_angle_axis(jnp.asarray(T[:3, :3], jnp.float32))) for T in Ts])
    uv1 = np.stack([project_np(K, Ts[j], pts)[0] for j in range(1, v + 1)], axis=1)
    uv1 = uv1 + rng.normal(0, 0.3, uv1.shape)
    valid = np.ones((n, v), bool)
    valid[::4, -1] = False
    args = (uv0, uv1, np.broadcast_to(K, (n, 3, 3)), np.broadcast_to(K, (n, v, 3, 3)),
            np.broadcast_to(aa[0], (n, 3)), np.broadcast_to(Ts[0][:3, 3], (n, 3)),
            np.broadcast_to(aa[1:], (n, v, 3)), np.broadcast_to(Ts[1:, :3, 3], (n, v, 3)), valid)
    args = tuple(np.ascontiguousarray(a, bool if a.dtype == bool else np.float32) for a in args)
    d0 = (depth * rng.uniform(0.85, 1.15, n)).astype(np.float32)
    return args, d0, depth


def test_depth_residual_matches_jax():
    args, d0, _ = _depth_problems(np.random.default_rng(3))
    ref = np.asarray(jax.vmap(jax_residual)(jnp.asarray(d0), *map(jnp.asarray, args)))
    got = depth_residual_track(_t(d0), *map(_t, args)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def test_lm_solve_scalar_matches_jax():
    args, d0, depth = _depth_problems(np.random.default_rng(4))
    d_ref, c_ref = jax_lm_scalar(jax_residual, jnp.asarray(d0), tuple(map(jnp.asarray, args)))
    d, c = lm_solve_scalar(depth_residual_track, _t(d0), tuple(map(_t, args)))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=1e-4)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), rtol=1e-3, atol=1e-3)
    assert np.abs(d.numpy() - depth).max() < 2e-2  # near the truth at 0.3 px noise


def test_depth_derivative_closed_form_matches_jvp():
    """The closed-form dr/d(depth) against forward mode through the same
    residual, in float64 (padded views included): 1e-6 relative to the
    largest entry (measured 0), and the solvers take it."""
    args, d0, _ = _depth_problems(np.random.default_rng(7), n=48, v=4)
    f64 = lambda a: torch.from_numpy(a if a.dtype == bool else a.astype(np.float64))  # noqa: E731
    targs = tuple(map(f64, args))
    d = f64(d0)
    r, dr = depth_residual_and_derivative(d, *targs)
    r_fwd, dr_fwd = torch.func.jvp(lambda x: depth_residual_track(x, *targs), (d,), (torch.ones_like(d),))
    assert torch.equal(r, r_fwd) and torch.equal(r, depth_residual_track(d, *targs))
    assert (dr - dr_fwd).abs().max() <= 1e-6 * dr_fwd.abs().max()
    assert depth_residual_track.with_derivative is depth_residual_and_derivative
    assert levenberg_marquardt._residual_and_jacobian(depth_residual_track, d, targs)[1] is not None


@pytest.mark.parametrize("solver", ["lm", "first_order"])
def test_optimize_depths_matches_jax(solver):
    """The whole depth solve (closed-form derivative) against the JAX
    package's on the same problems: 1e-4 relative (measured 8.3e-7 LM,
    2.4e-7 Adam)."""
    args, d0, depth = _depth_problems(np.random.default_rng(8), n=64, v=4)
    keys = ("uv0", "uv1", "K0", "K1", "pose0_aa", "pose0_t", "pose1_aa", "pose1_t", "valid")
    problems = dict(zip(keys, args), depth0=d0)
    got = optimize_depths(problems, solver=solver, first_order_iters=300, device="cpu")
    ref = jax_optimize_depths(problems, solver=solver, first_order_iters=300)
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert np.abs(got - depth).max() < 2e-2


@pytest.mark.parametrize("max_iters", [40, 1000])
def test_first_order_solve_matches_jax(max_iters):
    """Adam with optax's defaults and bias correction, and the global early
    stop (1000 iterations stop early; 40 run to the end)."""
    rng = np.random.default_rng(5)
    a = rng.uniform(0.5, 2.0, 16).astype(np.float32)
    b = rng.uniform(-3, 3, 16).astype(np.float32)
    x_ref, c_ref = jax_first_order(lambda x, ai, bi: (ai * x - bi)[None], jnp.zeros(16),
                                   (jnp.asarray(a), jnp.asarray(b)), max_iters=max_iters)
    x, c = first_order_solve(lambda x, ai, bi: (ai * x - bi)[:, None], torch.zeros(16),
                             (_t(a), _t(b)), max_iters=max_iters)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), rtol=1e-3, atol=1e-6)
