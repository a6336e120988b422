"""Depth residual of the SfM post-optimisation (port of
``onepose_plus_plus_tpu/geometry/residuals.py``; reference
``post_optimization/optimizer/residual.py:6-78``).

A keyframe observation is unprojected at its depth, carried to each related
view (angle-axis poses) and projected; the residual is the 2D offset to the
fine-refined match. Batched over tracks, so that one call gives every track's
residuals. Their derivative in the depth has a closed form
(:func:`depth_residual_and_derivative`), which the solvers of
``levenberg_marquardt.py`` take in place of a forward-mode pass
(``depth_residual_track.with_derivative``).
"""
from __future__ import annotations

import torch

from .rotations import angle_axis_rotate_point

_EPS = 1e-9


def unproject(uv: torch.Tensor, depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixel [..., 2] + depth [...] + K [..., 3, 3] -> camera-frame [..., 3]."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    x = (uv[..., 0] - cx) / fx * depth
    y = (uv[..., 1] - cy) / fy * depth
    return torch.stack([x, y, depth], dim=-1)


def _project_residual(pc1, K1, uv1, obs_valid):
    """(residual [..., V, 2], xy = the normalised point, z clamped away from 0,
    whether it was clamped) of camera-1 points."""
    z = pc1[..., 2:3]
    clamped = z.abs() < _EPS
    z = torch.where(clamped, torch.full_like(z, _EPS), z)
    xy = pc1[..., :2] / z
    u = K1[..., 0, 0] * xy[..., 0] + K1[..., 0, 2]
    v = K1[..., 1, 1] * xy[..., 1] + K1[..., 1, 2]
    r = (torch.stack([u, v], dim=-1) - uv1) * obs_valid[..., None].to(uv1.dtype)
    return r, xy, z, clamped


def _camera1_points(depth, uv0, K0, pose0_aa, pose0_t, pose1_aa, pose1_t):
    """(camera-1 points [..., V, 3], the keyframe ray K0^-1 [u, v, 1] [..., 3])."""
    ray0 = unproject(uv0, torch.ones_like(depth), K0)
    pw = angle_axis_rotate_point(-pose0_aa, depth[..., None] * ray0 - pose0_t)
    pc1 = angle_axis_rotate_point(pose1_aa, pw[..., None, :].expand(pose1_aa.shape)) + pose1_t
    return pc1, ray0


def depth_residual_track(depth, uv0, uv1, K0, K1, pose0_aa, pose0_t, pose1_aa, pose1_t,
                         obs_valid) -> torch.Tensor:
    """Residuals of each track's scalar depth against its V related views.

    Args (leading track dims ``...`` shared by all):
        depth: [...] keyframe depths; uv0: [..., 2]; uv1: [..., V, 2];
        K0: [..., 3, 3]; K1: [..., V, 3, 3]; pose0_aa / pose0_t: [..., 3]
        world->cam0; pose1_aa / pose1_t: [..., V, 3]; obs_valid: [..., V]
        (padded views give zero residual).
    Returns:
        [..., 2V] residuals in pixels (u, v interleaved per view).
    """
    pc1, _ = _camera1_points(depth, uv0, K0, pose0_aa, pose0_t, pose1_aa, pose1_t)
    return _project_residual(pc1, K1, uv1, obs_valid)[0].flatten(-2)


def depth_residual_and_derivative(depth, uv0, uv1, K0, K1, pose0_aa, pose0_t, pose1_aa, pose1_t,
                                  obs_valid):
    """(:func:`depth_residual_track`, its derivative in ``depth``), both
    [..., 2V], in closed form: with X0(d) = d K0^-1 [u, v, 1] the camera-1
    point moves along R1 R0^T K0^-1 [u, v, 1], and the projection's quotient
    rule gives du/dd = fx (dx z - x dz) / z^2 (dz = 0 where z is clamped, as
    forward mode differentiates the clamp)."""
    pc1, ray0 = _camera1_points(depth, uv0, K0, pose0_aa, pose0_t, pose1_aa, pose1_t)
    # the rotations are linear in the point: d pc1 / d depth = R1 R0^T ray0
    ray1 = angle_axis_rotate_point(
        pose1_aa, angle_axis_rotate_point(-pose0_aa, ray0)[..., None, :].expand(pose1_aa.shape))
    r, xy, z, clamped = _project_residual(pc1, K1, uv1, obs_valid)
    dz = torch.where(clamped, torch.zeros_like(z), ray1[..., 2:3])
    dxy = (ray1[..., :2] - xy * dz) / z
    f = torch.stack([K1[..., 0, 0], K1[..., 1, 1]], dim=-1)
    dr = dxy * f * obs_valid[..., None].to(uv1.dtype)
    return r.flatten(-2), dr.flatten(-2)


# the LM solvers take the closed form where a residual carries one
depth_residual_track.with_derivative = depth_residual_and_derivative
