"""Port parity of the pinhole projection helpers
(``geometry/projection.py``): ``tests/test_projection.py`` on the port, and
each function against the JAX package on the same seeded inputs (float32,
rtol 1e-5 / atol 1e-5 on pixels and points; the largest difference uses 40 %
of it: a pixel coordinate of ~400 to the ulp)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_plus_plus_tpu.geometry import projection as jproj
from onepose_plus_plus_tpu_torch.geometry import projection as proj
from onepose_plus_plus_tpu_torch.geometry.rotations import angle_axis_to_matrix


def _pose(aa, t):
    T = torch.eye(4)
    T[:3, :3] = angle_axis_to_matrix(torch.tensor(aa, dtype=torch.float32))
    T[:3, 3] = torch.tensor(t)
    return T


def test_project_unproject_roundtrip():
    K = torch.tensor([[500.0, 0, 256], [0, 500.0, 256], [0, 0, 1]])
    T = _pose([0.1, 0.2, -0.1], [0.05, -0.02, 1.5])
    pts = torch.from_numpy(np.random.RandomState(0).randn(100, 3).astype(np.float32) * 0.1)
    uv, depth = proj.project_points(K, T, pts)
    assert (depth > 0).all()
    cam = proj.unproject_depth(K, uv, depth)
    world = (cam - T[:3, 3]) @ T[:3, :3]
    np.testing.assert_allclose(world.numpy(), pts.numpy(), atol=1e-4)


def test_crop_resize_K():
    K = torch.tensor([[500.0, 0, 300], [0, 480.0, 200], [0, 0, 1]])
    K2 = proj.crop_resize_K(K, torch.tensor([100.0, 50.0, 356.0, 306.0]), (512, 512))
    assert float(K2[0, 2]) == (300 - 100) * 2.0
    assert float(K2[1, 2]) == (200 - 50) * 2.0
    assert float(K2[0, 0]) == 1000.0


def _inputs(seed, lead=(3,)):
    rng = np.random.default_rng(seed)
    K = np.zeros(lead + (3, 3), np.float32)
    K[..., 0, 0], K[..., 1, 1] = rng.uniform(400, 600, lead), rng.uniform(400, 600, lead)
    K[..., 0, 2], K[..., 1, 2], K[..., 2, 2] = rng.uniform(200, 300, lead), rng.uniform(200, 300, lead), 1
    T = np.tile(np.eye(4, dtype=np.float32), lead + (1, 1))
    q, _ = np.linalg.qr(rng.standard_normal(lead + (3, 3)))
    T[..., :3, :3] = q * np.sign(np.linalg.det(q))[..., None, None]
    T[..., :3, 3] = rng.normal(0, 0.1, lead + (3,)) + np.array([0, 0, 2.0])
    pts = rng.normal(0, 0.3, lead + (50, 3)).astype(np.float32)
    bbox = np.concatenate([rng.uniform(0, 100, lead + (2,)), rng.uniform(300, 500, lead + (2,))], -1)
    return K, T, pts, bbox.astype(np.float32)


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
def test_projection_matches_jax(lead):
    K, T, pts, bbox = _inputs(len(lead), lead)
    t = torch.from_numpy
    ok = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(proj.transform_points(t(T), t(pts)).numpy(),
                               np.asarray(jproj.transform_points(T, pts)), **ok)
    uv, depth = proj.project_points(t(K), t(T), t(pts))
    juv, jdepth = jproj.project_points(K, T, pts)
    np.testing.assert_allclose(uv.numpy(), np.asarray(juv), **ok)
    np.testing.assert_allclose(depth.numpy(), np.asarray(jdepth), **ok)
    np.testing.assert_allclose(proj.unproject_depth(t(K), uv, depth).numpy(),
                               np.asarray(jproj.unproject_depth(K, juv, jdepth)), **ok)
    np.testing.assert_allclose(proj.crop_resize_K(t(K), t(bbox), (256, 192)).numpy(),
                               np.asarray(jproj.crop_resize_K(jnp.asarray(K), jnp.asarray(bbox), (256, 192))), **ok)


def test_compose_K_matches_jax():
    got = proj.compose_K(500.0, 510.0, 250.5, 240.25)
    ref = np.asarray(jproj.compose_K(500.0, 510.0, 250.5, 240.25))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
