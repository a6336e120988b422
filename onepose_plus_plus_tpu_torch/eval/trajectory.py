"""Trajectory evaluation: Umeyama/Horn alignment + ATE.

The port's own copy of ``onepose_plus_plus_tpu/eval/trajectory.py`` (numpy only).

Behavioral port of reference ``src/utils/colmap/eval_helper.py`` (177 LoC:
``align`` Horn/Umeyama similarity alignment, ``quaternion_from_matrix``, ATE
computation between estimated and ground-truth camera trajectories).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def umeyama_alignment(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = True
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity transform: dst ~ s * R @ src + t.

    Args:
        src, dst: [N, 3] corresponding points (e.g. camera centers).
    Returns:
        (R [3, 3], t [3], s).
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (xs**2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def absolute_trajectory_error(
    est_centers: np.ndarray,
    gt_centers: np.ndarray,
    align: bool = True,
    with_scale: bool = True,
) -> dict:
    """ATE RMSE (+ per-frame errors) after optional similarity alignment."""
    if align:
        R, t, s = umeyama_alignment(est_centers, gt_centers, with_scale)
        est = est_centers @ (s * R).T + t
    else:
        est = est_centers
    err = np.linalg.norm(est - gt_centers, axis=1)
    return {
        "ate_rmse": float(np.sqrt(np.mean(err**2))),
        "ate_mean": float(np.mean(err)),
        "ate_median": float(np.median(err)),
        "errors": err,
    }


def camera_centers_from_poses(poses_w2c: np.ndarray) -> np.ndarray:
    """[N, 4, 4] world->cam -> camera centers [N, 3] (-R^T t)."""
    R = poses_w2c[:, :3, :3]
    t = poses_w2c[:, :3, 3]
    return -np.einsum("nji,nj->ni", R, t)
