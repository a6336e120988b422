"""Depth residual of the SfM post-optimisation (port of
``onepose_plus_plus_tpu/geometry/residuals.py``; reference
``post_optimization/optimizer/residual.py:6-78``).

A keyframe observation is unprojected at its depth, carried to each related
view (angle-axis poses) and projected; the residual is the 2D offset to the
fine-refined match. Batched over tracks, so that one call gives every track's
residuals (and autograd or the LM's forward-mode derivative their Jacobians).
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
    pc0 = unproject(uv0, depth, K0)
    pw = angle_axis_rotate_point(-pose0_aa, pc0 - pose0_t)  # world = R0^T (pc0 - t0)
    pc1 = angle_axis_rotate_point(pose1_aa, pw[..., None, :].expand(pose1_aa.shape)) + pose1_t
    z = pc1[..., 2:3]
    z = torch.where(z.abs() < _EPS, torch.full_like(z, _EPS), z)
    xy = pc1[..., :2] / z
    u = K1[..., 0, 0] * xy[..., 0] + K1[..., 0, 2]
    v = K1[..., 1, 1] * xy[..., 1] + K1[..., 1, 2]
    r = (torch.stack([u, v], dim=-1) - uv1) * obs_valid[..., None].to(uv1.dtype)
    return r.flatten(-2)
