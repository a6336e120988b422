"""Two-view epipolar geometry for match verification (port of
``onepose_plus_plus_tpu/geometry/epipolar.py``).

Camera poses are known in the OnePose++ SfM setting, so COLMAP's geometric
verification reduces to thresholding each match's distance to its epipolar
lines under the fundamental matrix of the relative pose: one batched
computation over every pair's padded match set.
"""
from __future__ import annotations

import torch

from .rotations import skew

_EPS = 1e-12


def relative_pose(T0: torch.Tensor, T1: torch.Tensor):
    """(R01, t01) with x1 = R01 x0 + t01, from world->cam poses [..., 4, 4]."""
    R0, t0 = T0[..., :3, :3], T0[..., :3, 3]
    R1, t1 = T1[..., :3, :3], T1[..., :3, 3]
    R01 = R1 @ R0.transpose(-1, -2)
    t01 = t1 - torch.einsum("...ij,...j->...i", R01, t0)
    return R01, t01


def essential_from_poses(T0: torch.Tensor, T1: torch.Tensor) -> torch.Tensor:
    """Essential matrix [..., 3, 3] with x1n^T E x0n = 0 (normalised coords)."""
    R01, t01 = relative_pose(T0, T1)
    return skew(t01) @ R01


def fundamental_from_poses(K0, K1, T0, T1) -> torch.Tensor:
    """Fundamental matrix [..., 3, 3] with x1^T F x0 = 0 (pixel coords)."""
    E = essential_from_poses(T0, T1)
    return torch.linalg.inv(K1).transpose(-1, -2) @ E @ torch.linalg.inv(K0)


def epipolar_error(F: torch.Tensor, pts0: torch.Tensor, pts1: torch.Tensor) -> torch.Tensor:
    """Symmetric point-to-epipolar-line distance in pixels (COLMAP's metric):
    F [..., 3, 3], pts [..., N, 2] -> [..., N]."""
    ones = torch.ones_like(pts0[..., :1])
    x0 = torch.cat([pts0, ones], dim=-1)
    x1 = torch.cat([pts1, ones], dim=-1)
    Fx0 = torch.einsum("...ij,...nj->...ni", F, x0)
    Ftx1 = torch.einsum("...ji,...nj->...ni", F, x1)
    x1Fx0 = (x1 * Fx0).sum(dim=-1).abs()
    d1 = x1Fx0 / torch.sqrt(Fx0[..., 0] ** 2 + Fx0[..., 1] ** 2 + _EPS)
    d0 = x1Fx0 / torch.sqrt(Ftx1[..., 0] ** 2 + Ftx1[..., 1] ** 2 + _EPS)
    return 0.5 * (d0 + d1)


def verify_matches(K0, K1, T0, T1, pts0, pts1, valid, max_error_px: float = 4.0) -> torch.Tensor:
    """Batched geometric verification of fixed-capacity match sets.

    Args:
        K0, K1: [B, 3, 3]; T0, T1: [B, 4, 4] world->cam; pts0, pts1: [B, N, 2];
        valid: [B, N] bool mask of the filled slots.
    Returns:
        inlier mask [B, N] bool (a subset of ``valid``).
    """
    F = fundamental_from_poses(K0, K1, T0, T1)
    return valid & (epipolar_error(F, pts0, pts1) <= max_error_px)
