"""SO(3) helpers (port of ``onepose_plus_plus_tpu/geometry/rotations.py``)."""
from __future__ import annotations

import torch

_EPS = 1e-8


def skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> cross-product matrix [..., 3, 3]."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def angle_axis_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """Rodrigues: angle-axis [..., 3] -> rotation matrix [..., 3, 3] (Taylor
    terms near theta = 0)."""
    theta2 = (aa * aa).sum(dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    sin_over = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    one_minus_cos_over = torch.where(
        small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / (theta2 + _EPS)
    )
    K = skew(aa)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    return eye + sin_over[..., None, None] * K + one_minus_cos_over[..., None, None] * (K @ K)
