"""Pose-error metrics. The numpy functions are shared with the JAX package
(``onepose_plus_plus_tpu.eval.metrics``, which loads no JAX); the batched
device version is ported."""
from __future__ import annotations

from typing import Tuple

import torch

from onepose_plus_plus_tpu.eval.metrics import aggregate_metrics  # noqa: F401  (re-exported)


def batched_pose_errors(pose_pred: torch.Tensor, pose_gt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, 4, 4] x2 -> (rotation error deg [B], translation error cm [B])."""
    t_err = torch.linalg.norm(pose_pred[:, :3, 3] - pose_gt[:, :3, 3], dim=-1) * 100.0
    R_rel = pose_pred[:, :3, :3] @ pose_gt[:, :3, :3].transpose(-1, -2)
    tr = R_rel[:, 0, 0] + R_rel[:, 1, 1] + R_rel[:, 2, 2]
    cos = ((tr - 1.0) / 2.0).clamp(-1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos)), t_err
