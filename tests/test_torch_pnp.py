"""Port parity: RANSAC-PnP, its solvers and the pose metrics against the JAX package.

The solvers run on identical numpy-drawn samples in both packages. RANSAC
sampling cannot be shared (``jax.random`` vs ``torch.Generator``), so the
JAX package's own samples are fed to ``ransac_pnp_from_samples``, and both
``ransac_pnp`` entries are held to ground truth on synthetic scenes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_plus_plus_tpu.eval.metrics import batched_pose_errors as jax_pose_errors
from onepose_plus_plus_tpu.geometry import pnp as jpnp
from onepose_plus_plus_tpu.geometry.rotations import angle_axis_to_matrix as jax_aa2m
from onepose_plus_plus_tpu_torch.eval.metrics import batched_pose_errors
from onepose_plus_plus_tpu_torch.geometry import pnp
from onepose_plus_plus_tpu_torch.geometry.rotations import angle_axis_to_matrix
from synthetic_scenes import make_scene

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _normalized(K, T, pts, noise_px, rng):
    pc = pts @ T[:3, :3].T + T[:3, 3]
    uv = pc[:, :2] / pc[:, 2:3]
    return uv + rng.normal(0, noise_px / K[0, 0], uv.shape)


def _samples(h=24, s=6, planar=False, seed=0):
    """h samples of s correspondences (normalised coords) seen by one camera."""
    rng = np.random.default_rng(seed)
    K, pts, Ts = make_scene(rng, n_views=1, n_pts=h * s)
    if planar:
        pts[:, 2] = 0.05 * pts[:, 0] - 0.02
    x2 = _normalized(K, Ts[0], pts, 0.2, rng)
    return (pts.reshape(h, s, 3).astype(np.float32), x2.reshape(h, s, 2).astype(np.float32), Ts[0])


def _rot_err_deg(Ra, Rb):
    """Angle between rotations, from ||Ra - Rb||_F = 2 sqrt(2) sin(theta / 2)
    in float64 (arccos of the trace loses small angles in f32)."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64), axis=(-2, -1))
    return np.rad2deg(2 * np.arcsin(np.clip(d / (2 * np.sqrt(2)), 0, 1)))


def test_fit_pose_dlt():
    p3, p2, T = _samples(s=10)
    Rj, tj = jax.vmap(jpnp._fit_pose_dlt)(p3, p2)
    Rt, tt = pnp._fit_pose_dlt(_t(p3), _t(p2))
    assert _rot_err_deg(Rt.numpy(), np.asarray(Rj)).max() < 0.01
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-3)
    assert np.median(_rot_err_deg(Rt.numpy(), T[:3, :3])) < 2.0  # hypotheses near the pose


def test_fit_pose_planar():
    p3, p2, T = _samples(s=8, planar=True, seed=1)
    Rj, tj = jax.vmap(jpnp._fit_pose_planar)(p3, p2)
    Rt, tt = pnp._fit_pose_planar(_t(p3), _t(p2))
    assert Rt.shape == (24, 2, 3, 3) and tt.shape == (24, 2, 3)
    assert _rot_err_deg(Rt.numpy(), np.asarray(Rj)).max() < 0.01
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-3)
    best = _rot_err_deg(Rt.numpy(), T[:3, :3]).min(axis=1)  # one of the two is near the pose
    assert np.median(best) < 3.0


def test_fit_pose_p3p():
    p3, p2, T = _samples(s=3, seed=2)
    Rj, tj = (np.asarray(a) for a in jax.vmap(jpnp._fit_pose_p3p)(p3, p2))
    Rt, tt = (a.numpy() for a in pnp._fit_pose_p3p(_t(p3), _t(p2)))
    assert Rt.shape == (24, 4, 3, 3)
    fin_j = np.isfinite(Rj).all(axis=(-2, -1))
    fin_t = np.isfinite(Rt).all(axis=(-2, -1))
    # a root on the edge of the validity test (|imag| < 1e-4 (1 + |re|), u > 0)
    # may fall either way in the two packages' complex64 arithmetic
    assert (fin_t == fin_j).mean() >= 0.95
    both = fin_t & fin_j
    # complex64 Ferrari + Newton polish: candidates near a double root are
    # sensitive to rounding; the bulk agrees to ~1e-3 deg
    err = _rot_err_deg(Rt[both], Rj[both])
    assert np.median(err) < 0.01 and np.quantile(err, 0.9) < 0.5
    t_err = np.abs(tt[both] - tj[both]).max(axis=-1)
    assert np.median(t_err) < 1e-4
    near = np.where(fin_t, _rot_err_deg(np.nan_to_num(Rt), T[:3, :3]), np.inf).min(axis=1)
    assert np.median(near) < 1.0


def test_quartic_roots():
    c = np.random.default_rng(3).standard_normal((16, 5)).astype(np.float32)
    rj = np.asarray(jax.vmap(jpnp._solve_quartic)(c))
    rt = pnp._solve_quartic(_t(c)).numpy()
    # the same four roots; a conjugate pair may come out in the other order
    # when a near-zero imaginary part takes the other sign
    dist = np.abs(rt[:, :, None] - rj[:, None, :]).min(axis=-1)
    assert dist.max() < 1e-3
    np.testing.assert_allclose(np.abs(rt).sum(-1), np.abs(rj).sum(-1), rtol=1e-4)


def test_reproj_errors_and_refine():
    rng = np.random.default_rng(4)
    K, pts, Ts = make_scene(rng, n_views=1, n_pts=64)
    x2 = _normalized(K, Ts[0], pts, 0.3, rng).astype(np.float32)
    R0 = np.asarray(jax_aa2m(jnp.asarray([0.02, -0.01, 0.015]))) @ Ts[0][:3, :3]
    t0 = Ts[0][:3, 3] + np.array([0.01, -0.02, 0.03])
    R0, t0, pts = R0.astype(np.float32), t0.astype(np.float32), pts.astype(np.float32)
    w = (rng.random(64) > 0.1).astype(np.float32)
    ej = np.asarray(jpnp._reproj_errors(R0, t0, pts, x2))
    et = pnp._reproj_errors(_t(R0), _t(t0), _t(pts), _t(x2)).numpy()
    np.testing.assert_allclose(et, ej, rtol=1e-5, atol=1e-10)
    Rj, tj = jpnp._gauss_newton_refine(R0, t0, pts, x2, w, iters=10)
    Rt, tt = pnp._gauss_newton_refine(_t(R0)[None], _t(t0)[None], _t(pts)[None], _t(x2)[None],
                                      _t(w)[None], iters=10)
    assert _rot_err_deg(Rt[0].numpy(), np.asarray(Rj)) < 1e-3
    np.testing.assert_allclose(tt[0].numpy(), np.asarray(tj), atol=1e-5)
    assert _rot_err_deg(Rt[0].numpy(), Ts[0][:3, :3]) < 0.2


def _scene_batch(seed, b=3, n=160, outliers=0.2):
    rng = np.random.default_rng(seed)
    K, pts, Ts = make_scene(rng, n_views=b, n_pts=n)
    p2 = []
    for T in Ts:
        uv = _normalized(K, T, pts, 0.5, rng) @ K[:2, :2].T + K[:2, 2]
        bad = rng.random(n) < outliers
        uv[bad] = rng.uniform(0, 512, (bad.sum(), 2))
        p2.append(uv)
    valid = np.ones((b, n), bool)
    valid[:, -10:] = False  # padded slots
    return (np.tile(pts, (b, 1, 1)).astype(np.float32), np.stack(p2).astype(np.float32),
            np.tile(K, (b, 1, 1)).astype(np.float32), valid, Ts)


def test_ransac_pnp_recovers_pose_in_both_packages():
    p3, p2, K, valid, Ts = _scene_batch(5)
    res_j = jpnp.ransac_pnp_batch(p3, p2, K, valid, jax.random.PRNGKey(0), num_hypotheses=128)
    gen = torch.Generator()
    gen.manual_seed(0)
    res_t = pnp.ransac_pnp(_t(p3), _t(p2), _t(K), torch.from_numpy(valid), gen, num_hypotheses=128)
    for R, t, ok in ((np.asarray(res_j.R), np.asarray(res_j.t), np.asarray(res_j.ok)),
                     (res_t.R.numpy(), res_t.t.numpy(), res_t.ok.numpy())):
        assert ok.all()
        assert (_rot_err_deg(R, Ts[:, :3, :3]) < 1.0).all()
        assert (np.linalg.norm(t - Ts[:, :3, 3], axis=-1) * 100 < 2.0).all()


def test_ransac_from_jax_samples_matches_jax():
    """Fed the samples that JAX's ransac_pnp draws from its key, the port picks
    the same hypothesis and refines it to the same pose."""
    p3, p2, K, valid, _ = _scene_batch(6, b=1)
    key, h, sub = jax.random.PRNGKey(3), 96, 128
    res_j = jpnp.ransac_pnp(p3[0], p2[0], K[0], valid[0], key, num_hypotheses=h)
    # the sampling of onepose_plus_plus_tpu/geometry/pnp.py:555-607
    n = valid.shape[1]
    scores = jnp.where(valid[0][None], jax.random.gumbel(key, (h, n)), -jnp.inf)
    idxs = []
    for _ in range(6):
        i = jnp.argmax(scores, axis=-1)
        idxs.append(i)
        scores = jnp.where(jnp.arange(n)[None] == i[:, None], -jnp.inf, scores)
    sample_idx = np.asarray(jnp.stack(idxs, axis=-1))
    gs = jnp.where(valid[0], jax.random.gumbel(jax.random.fold_in(key, 1), (n,)), -jnp.inf)
    sub_idx = np.asarray(jax.lax.top_k(gs, sub)[1])
    res_t = pnp.ransac_pnp_from_samples(
        _t(p3), _t(p2), _t(K), torch.from_numpy(valid),
        torch.from_numpy(sample_idx[None]).long(), torch.from_numpy(sub_idx[None]).long(),
    )
    assert bool(res_t.ok[0]) and bool(res_j.ok)
    assert _rot_err_deg(res_t.R[0].numpy(), np.asarray(res_j.R)) < 0.01
    np.testing.assert_allclose(res_t.t[0].numpy(), np.asarray(res_j.t), atol=1e-4)
    assert abs(int(res_t.num_inliers[0]) - int(res_j.num_inliers)) <= 1


def test_sample_hypotheses_draws_distinct_valid_slots():
    valid = torch.zeros(2, 50, dtype=torch.bool)
    valid[:, :30] = True
    gen = torch.Generator()
    gen.manual_seed(1)
    idx, sub = pnp.sample_hypotheses(valid, gen, num_hypotheses=64, prescore_subset=20)
    assert idx.shape == (2, 64, 6) and sub.shape == (2, 20)
    assert (idx < 30).all() and (sub < 30).all()
    assert all(len(set(row.tolist())) == 6 for row in idx.reshape(-1, 6))


def test_angle_axis_and_pose_errors():
    rng = np.random.default_rng(7)
    aa = (rng.standard_normal((8, 3)) * np.array([[1.0]] * 4 + [[1e-5]] * 4)).astype(np.float32)
    np.testing.assert_allclose(angle_axis_to_matrix(_t(aa)).numpy(), np.asarray(jax_aa2m(aa)), atol=1e-6)
    a = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    a[:, :3, :3] = np.asarray(jax_aa2m(aa))
    a[:, :3, 3] = rng.standard_normal((8, 3))
    b = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    rj, tj = jax_pose_errors(jnp.asarray(a), jnp.asarray(b))
    rt, tt = batched_pose_errors(_t(a), _t(b))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-6)


@pytest.mark.parametrize("planar,p3p", [(False, False), (True, False), (False, True)])
def test_hypothesis_family_toggles(planar, p3p):
    p3, p2, K, valid, Ts = _scene_batch(8, b=2, outliers=0.1)
    gen = torch.Generator()
    gen.manual_seed(2)
    res = pnp.ransac_pnp(_t(p3), _t(p2), _t(K), torch.from_numpy(valid), gen, num_hypotheses=64,
                         planar_hypotheses=planar, p3p_hypotheses=p3p)
    assert res.ok.all()
    assert (_rot_err_deg(res.R.numpy(), Ts[:, :3, :3]) < 1.0).all()
