"""SO(3) helpers (port of ``onepose_plus_plus_tpu/geometry/rotations.py``):
Rodrigues, the angle-axis point rotation of the depth residual, the log map,
and COLMAP quaternion conversions, batched over leading dimensions."""
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


def angle_axis_rotate_point(aa: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Rotate points [..., 3] by angle-axis [..., 3] without forming the matrix:
    p cos t + (k x p) sin t + k (k . p)(1 - cos t); p + aa x p when t is tiny."""
    theta2 = (aa * aa).sum(dim=-1, keepdim=True)
    theta = torch.sqrt(theta2 + _EPS)
    k = aa / theta
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    kxp = torch.cross(k, pts, dim=-1)
    kdotp = (k * pts).sum(dim=-1, keepdim=True)
    rotated = pts * cos_t + kxp * sin_t + k * kdotp * (1.0 - cos_t)
    return torch.where(theta2 < 1e-12, pts + torch.cross(aa, pts, dim=-1), rotated)


def matrix_to_angle_axis(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> angle-axis [..., 3] (log map through the
    quaternion, robust at theta ~ 0 and theta ~ pi)."""
    q = matrix_to_qvec(R)  # w >= 0
    w, xyz = q[..., 0], q[..., 1:]
    norm = torch.linalg.norm(xyz, dim=-1)
    theta = 2.0 * torch.atan2(norm, w)
    scale = torch.where(norm < 1e-9, 2.0 / w.clamp_min(_EPS), theta / (norm + _EPS))
    return xyz * scale[..., None]


def qvec_to_matrix(qvec: torch.Tensor) -> torch.Tensor:
    """COLMAP quaternion [..., 4] (w, x, y, z) -> rotation matrix [..., 3, 3]."""
    w, x, y, z = qvec.unbind(-1)
    return torch.stack(
        [
            torch.stack([1 - 2 * y**2 - 2 * z**2, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w], -1),
            torch.stack([2 * x * y + 2 * z * w, 1 - 2 * x**2 - 2 * z**2, 2 * y * z - 2 * x * w], -1),
            torch.stack([2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x**2 - 2 * y**2], -1),
        ],
        dim=-2,
    )


def matrix_to_qvec(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> COLMAP quaternion [..., 4] (w, x, y, z),
    w >= 0. Branch-free Shepperd construction: the candidate with the largest
    pivot wins."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def root(x):
        return torch.sqrt(x.clamp_min(_EPS)) / 2.0

    qw0 = root(1.0 + tr)
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0), (m10 - m01) / (4 * qw0)], -1)
    qx1 = root(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1)], -1)
    qy2 = root(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2)], -1)
    qz3 = root(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3], -1)
    pivots = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], -1)
    best = torch.argmax(pivots, dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)  # [..., 4, 4]
    q = torch.gather(qs, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    return q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)
