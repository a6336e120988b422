"""Pinhole camera projection (port of ``onepose_plus_plus_tpu/geometry/projection.py``;
reference ``src/utils/data_utils.py:239-299``), batched over leading dims."""
from __future__ import annotations

import torch

_EPS = 1e-9


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a rigid transform T [..., 4, 4] (or [..., 3, 4]) to points [..., N, 3]."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def project_points(K: torch.Tensor, T: torch.Tensor, pts3d: torch.Tensor):
    """World points [..., N, 3] through world->camera T [..., 4, 4] and K
    [..., 3, 3] -> (uv [..., N, 2] pixels, depth [..., N] camera-frame z)."""
    pc = transform_points(T, pts3d)
    uvw = pc @ K.transpose(-1, -2)
    return uvw[..., :2] / (uvw[..., 2:3] + _EPS), pc[..., 2]


def unproject_depth(K: torch.Tensor, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Lift pixels [..., N, 2] with depth [..., N] into camera-frame points [..., N, 3]."""
    fx, fy = K[..., 0, 0][..., None], K[..., 1, 1][..., None]
    cx, cy = K[..., 0, 2][..., None], K[..., 1, 2][..., None]
    x = (uv[..., 0] - cx) / fx * depth
    y = (uv[..., 1] - cy) / fy * depth
    return torch.stack([x, y, depth], dim=-1)


def compose_K(fx, fy, cx, cy, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], dtype=dtype, device=device)


def crop_resize_K(K: torch.Tensor, bbox_xyxy: torch.Tensor, out_hw) -> torch.Tensor:
    """Intrinsics after a crop to bbox [..., 4] = (x0, y0, x1, y1) and a resize
    to ``out_hw`` (reference ``get_K_crop_resize``): the crop shifts the
    principal point, the resize scales it and the focal lengths."""
    x0, y0, x1, y1 = bbox_xyxy.unbind(-1)
    out_h, out_w = out_hw
    sx = out_w / (x1 - x0)
    sy = out_h / (y1 - y0)
    K_new = torch.zeros_like(K)
    K_new[..., 0, 0] = K[..., 0, 0] * sx
    K_new[..., 1, 1] = K[..., 1, 1] * sy
    K_new[..., 0, 2] = (K[..., 0, 2] - x0) * sx
    K_new[..., 1, 2] = (K[..., 1, 2] - y0) * sy
    K_new[..., 2, 2] = 1.0
    return K_new
