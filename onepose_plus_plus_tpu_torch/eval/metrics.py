"""Pose-error metrics (port of ``onepose_plus_plus_tpu/eval/metrics.py``):
the batched device version and the port's own copy of the numpy
``aggregate_metrics``."""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch


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
