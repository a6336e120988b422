"""Pose-error metrics (port of ``onepose_plus_plus_tpu/eval/metrics.py``):
the batched device version and the port's own copies of the numpy functions
(reference ``src/utils/metric_utils.py``): ``query_pose_error`` (rotation deg,
translation cm), ``add_metric`` (ADD, or ADD-S by nearest neighbour for the
symmetric LINEMOD objects), ``projection_2d_error``,
``model_diameter_from_bbox`` and ``aggregate_metrics``."""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch


# LINEMOD symmetric objects (reference metric_utils.py:237)
SYMMETRIC_OBJ_IDS = ("0810", "0811")  # eggbox, glue


def query_pose_error(
    pose_pred: np.ndarray, pose_gt: np.ndarray
) -> tuple:
    """(rotation error deg, translation error cm) between 4x4 (or 3x4) poses."""
    t_err = np.linalg.norm(pose_pred[:3, 3] - pose_gt[:3, 3]) * 100.0
    R_rel = pose_pred[:3, :3] @ pose_gt[:3, :3].T
    cos = np.clip((np.trace(R_rel) - 1.0) / 2.0, -1.0, 1.0)
    r_err = np.rad2deg(np.arccos(cos))
    return float(r_err), float(t_err)


def add_metric(
    pose_pred: np.ndarray,
    pose_gt: np.ndarray,
    model_points: np.ndarray,
    diameter: float,
    symmetric: bool = False,
    percentage: float = 0.1,
) -> bool:
    """ADD(-S) test: mean (closest-point) distance < percentage * diameter."""
    pred = model_points @ pose_pred[:3, :3].T + pose_pred[:3, 3]
    gt = model_points @ pose_gt[:3, :3].T + pose_gt[:3, 3]
    if symmetric:
        from scipy.spatial import cKDTree

        tree = cKDTree(pred)
        dists, _ = tree.query(gt, k=1)
        mean_dist = float(np.mean(dists))
    else:
        mean_dist = float(np.mean(np.linalg.norm(pred - gt, axis=-1)))
    return mean_dist < diameter * percentage


def projection_2d_error(
    pose_pred: np.ndarray,
    pose_gt: np.ndarray,
    model_points: np.ndarray,
    K: np.ndarray,
    threshold_px: float = 5.0,
) -> bool:
    """Mean 2D reprojection distance of model points < threshold."""

    def proj(pose):
        pc = model_points @ pose[:3, :3].T + pose[:3, 3]
        uv = pc[:, :2] / pc[:, 2:3]
        return uv @ K[:2, :2].T + K[:2, 2]

    d = np.linalg.norm(proj(pose_pred) - proj(pose_gt), axis=-1)
    return float(np.mean(d)) < threshold_px


def model_diameter_from_bbox(corners_3d: np.ndarray) -> float:
    """Object diameter as the 3D-bbox diagonal (reference
    ``sample_points_on_cad.py:model_diameter_from_bbox``)."""
    lo = corners_3d.min(axis=0)
    hi = corners_3d.max(axis=0)
    return float(np.linalg.norm(hi - lo))


def batched_pose_errors(pose_pred: torch.Tensor, pose_gt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, 4, 4] x2 -> (rotation error deg [B], translation error cm [B])."""
    t_err = torch.linalg.norm(pose_pred[:, :3, 3] - pose_gt[:, :3, 3], dim=-1) * 100.0
    R_rel = pose_pred[:, :3, :3] @ pose_gt[:, :3, :3].transpose(-1, -2)
    tr = R_rel[:, 0, 0] + R_rel[:, 1, 1] + R_rel[:, 2, 2]
    cos = ((tr - 1.0) / 2.0).clamp(-1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos)), t_err


def aggregate_metrics(
    R_errs: Sequence[float],
    t_errs: Sequence[float],
    add_flags: Optional[Iterable[bool]] = None,
    proj2d_flags: Optional[Iterable[bool]] = None,
    pose_thresholds: Sequence[float] = (1, 3, 5),
) -> Dict[str, float]:
    """Accuracy table: {X}cm@{X}degree ratios + ADD / proj2D means.

    Mirrors reference ``aggregate_metrics`` (``metric_utils.py:295-315``): a
    pose is correct at threshold X when BOTH rotation < X deg and translation
    < X cm.
    """
    R = np.asarray(list(R_errs), dtype=np.float64)
    t = np.asarray(list(t_errs), dtype=np.float64)
    out: Dict[str, float] = {}
    for thr in pose_thresholds:
        ok = (R < thr) & (t < thr)
        out[f"{thr}cm@{thr}degree"] = float(np.mean(ok)) if len(ok) else 0.0
    if add_flags is not None:
        flags = np.asarray(list(add_flags), dtype=bool)
        out["ADD metric"] = float(np.mean(flags)) if len(flags) else 0.0
    if proj2d_flags is not None:
        flags = np.asarray(list(proj2d_flags), dtype=bool)
        out["proj2D metric"] = float(np.mean(flags)) if len(flags) else 0.0
    return out
