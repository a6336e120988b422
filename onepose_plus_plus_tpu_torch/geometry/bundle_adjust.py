"""Extrinsics-only refinement and two-view relative pose (port of
``onepose_plus_plus_tpu/geometry/bundle_adjust.py``).

* :func:`refine_extrinsics`: COLMAP's bundle adjuster with only the
  extrinsics refined. With the 3D points fixed, every camera's pose is an
  independent 6-parameter least squares, solved for all cameras at once by
  the batched ``lm_solve`` with the residual's Jacobian in closed form.
* :func:`estimate_relative_pose`: RANSAC over 8-point essential matrices,
  a consensus refit and the cheirality test, the seed step of the
  unknown-pose mapper (``sfm/incremental.py``). Samples come from an explicit
  ``torch.Generator`` (:func:`sample_relative_pose`) or are passed in.

Batched ``eigh`` and ``svd`` run in chunks of ``EIGH_CHUNK`` matrices
(cuSOLVER refuses large batches, ``triangulation.py``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.matching import topk_stable
from .levenberg_marquardt import lm_solve
from .rotations import angle_axis_to_matrix, matrix_to_angle_axis, skew
from .triangulation import EIGH_CHUNK, triangulate_tracks

_EPS = 1e-9


def _chunked(fn, x: torch.Tensor):
    """fn over the leading dim of x in chunks of EIGH_CHUNK, results concatenated."""
    outs = [fn(c) for c in x.split(EIGH_CHUNK)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


# ------------------------- extrinsics-only refinement ------------------------


def _project(params, pts3d, K):
    """(pc [C, M, 3], z clamped away from 0, whether clamped, uv_hat [C, M, 2])."""
    R = angle_axis_to_matrix(params[:, :3])
    pc = pts3d @ R.transpose(-1, -2) + params[:, None, 3:]
    z = pc[..., 2:3]
    clamped = z.abs() < _EPS
    z = torch.where(clamped, torch.full_like(z, _EPS), z)
    xy = pc[..., :2] / z
    f = torch.stack([K[:, 0, 0], K[:, 1, 1]], dim=-1)[:, None]
    c = torch.stack([K[:, 0, 2], K[:, 1, 2]], dim=-1)[:, None]
    return pc, z, clamped, xy * f + c


def _cam_residual(params, pts3d, uv, K, valid):
    """Pose residuals of C cameras: params [C, 6] = [aa, t], pts3d [C, M, 3],
    uv [C, M, 2], K [C, 3, 3], valid [C, M] -> [C, 2M] (u, v interleaved)."""
    uv_hat = _project(params, pts3d, K)[3]
    return ((uv_hat - uv) * valid[..., None].to(uv.dtype)).flatten(-2)


def _cam_residual_and_jacobian(params, pts3d, uv, K, valid):
    """(:func:`_cam_residual`, its Jacobian [C, 2M, 6]) in closed form.

    With q = R(aa) p, d q / d aa = -[q]x J_l(aa), J_l = I + (1 - cos th)/th^2
    [aa]x + (th - sin th)/th^3 [aa]x^2 (SO(3)'s left Jacobian; Taylor terms
    for small th), and d pc / d t = I; the projection's quotient rule maps
    d pc to pixels (no z term where z is clamped, as forward mode gives).
    """
    aa = params[:, :3]
    pc, z, clamped, uv_hat = _project(params, pts3d, K)
    w = valid[..., None].to(uv.dtype)
    r = ((uv_hat - uv) * w).flatten(-2)
    th2 = (aa * aa).sum(dim=-1)
    th = torch.sqrt(th2)
    small = th2 < 1e-6
    safe = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(safe)) / (safe * safe))
    b = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (safe - torch.sin(safe)) / (safe * safe * safe))
    A = skew(aa)
    eye = torch.eye(3, dtype=params.dtype, device=params.device)
    J_l = eye + a[:, None, None] * A + b[:, None, None] * (A @ A)  # [C, 3, 3]
    q = pc - params[:, None, 3:]
    dpc = torch.cat([-skew(q) @ J_l[:, None], eye.expand(*q.shape[:2], 3, 3)], dim=-1)  # [C, M, 3, 6]
    xy = pc[..., :2] / z
    dz = torch.where(clamped, torch.zeros_like(z), torch.ones_like(z))[..., None] * dpc[..., 2:3, :]
    dxy = (dpc[..., :2, :] - xy[..., None] * dz) / z[..., None]
    f = torch.stack([K[:, 0, 0], K[:, 1, 1]], dim=-1)[:, None, :, None]
    J = dxy * f * w[..., None]  # [C, M, 2, 6]
    return r, J.flatten(1, 2)


_cam_residual.with_derivative = _cam_residual_and_jacobian


def refine_extrinsics(T_init, K, pts3d, uv, valid, max_iters: int = 50):
    """Refine every camera's pose against its fixed 3D observations.

    Args:
        T_init: [C, 4, 4] world->cam; K: [C, 3, 3]; pts3d: [C, M, 3] each
        camera's observed points (padded); uv: [C, M, 2]; valid: [C, M].
    Returns:
        (T [C, 4, 4], final cost [C]); a camera whose solution is not finite
        keeps its initial pose.
    """
    aa = matrix_to_angle_axis(T_init[:, :3, :3])
    x0 = torch.cat([aa, T_init[:, :3, 3]], dim=1)
    x, cost = lm_solve(_cam_residual, x0, (pts3d, uv, K, valid), max_iters=max_iters)
    T = torch.eye(4, dtype=T_init.dtype, device=T_init.device).repeat(T_init.shape[0], 1, 1)
    T[:, :3, :3] = angle_axis_to_matrix(x[:, :3])
    T[:, :3, 3] = x[:, 3:]
    ok = torch.isfinite(x).all(dim=1)
    return torch.where(ok[:, None, None], T, T_init), cost


# ------------------------- two-view relative pose ---------------------------


class RelativePose(NamedTuple):
    R: torch.Tensor  # [3, 3] cam0 -> cam1
    t: torch.Tensor  # [3] unit-norm translation
    inliers: torch.Tensor  # [N] bool
    num_inliers: torch.Tensor  # int32
    ok: torch.Tensor  # bool


def _essential_8pt(p0n, p1n, weights: Optional[torch.Tensor] = None):
    """Normalised 8-point: E [..., 3, 3] from [..., S >= 8, 2] normalised
    correspondences (weighted for the consensus refit), projected onto the
    essential manifold (singular values 1, 1, 0)."""
    x0, y0 = p0n[..., 0], p0n[..., 1]
    x1, y1 = p1n[..., 0], p1n[..., 1]
    A = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0, torch.ones_like(x0)], dim=-1)
    if weights is not None:
        A = A * weights[..., None]
    AtA = A.transpose(-1, -2) @ A
    lead = AtA.shape[:-2]
    vecs = _chunked(lambda m: (torch.linalg.eigh(m)[1],), AtA.reshape(-1, 9, 9))[0]
    E = vecs[..., :, 0].reshape(*lead, 3, 3)
    U, _, Vh = _chunked(lambda m: torch.linalg.svd(m), E.reshape(-1, 3, 3))
    diag = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return ((U * diag) @ Vh).reshape(*lead, 3, 3)


def _decompose_E(E: torch.Tensor):
    """The four (R, t) candidates of E [3, 3]: R [4, 3, 3], t [4, 3]."""
    U, _, Vh = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U @ Vh))  # det(R) = +1 without a branch
    W = torch.tensor([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=E.dtype, device=E.device)
    R1, R2 = U @ W @ Vh, U @ W.T @ Vh
    t = U[:, 2]
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _sampson_normalized(E, p0n, p1n):
    """Sampson distances [..., N] of E [..., 3, 3] on normalised points [N, 2]."""
    ones = torch.ones_like(p0n[:, :1])
    x0 = torch.cat([p0n, ones], dim=1)
    x1 = torch.cat([p1n, ones], dim=1)
    Ex0 = x0 @ E.transpose(-1, -2)
    Etx1 = x1 @ E
    x1Ex0 = (x1 * Ex0).sum(dim=-1)
    denom = Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2 + Etx1[..., 0] ** 2 + Etx1[..., 1] ** 2
    return x1Ex0 ** 2 / (denom + _EPS)


def sample_relative_pose(valid: torch.Tensor, generator: torch.Generator, num_hypotheses: int = 256,
                         sample_size: int = 8) -> torch.Tensor:
    """RANSAC samples [H, S]: Gumbel top-S over the valid correspondences of
    each hypothesis (distinct, without replacement)."""
    u = torch.rand((num_hypotheses, valid.shape[0]), generator=generator, device=valid.device)
    g = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    scores = torch.where(valid[None, :], g, torch.full_like(g, float("-inf")))
    return topk_stable(scores, sample_size)[1]


def estimate_relative_pose(
    pts0: torch.Tensor,
    pts1: torch.Tensor,
    K0: torch.Tensor,
    K1: torch.Tensor,
    valid: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    threshold_px: float = 4.0,
    num_hypotheses: int = 256,
    sample_size: int = 8,
    samples: Optional[torch.Tensor] = None,
) -> RelativePose:
    """RANSAC essential-matrix relative pose from pixel correspondences
    pts0, pts1 [N, 2] (``valid`` [N]); translation is unit-norm (the
    monocular gauge). ``samples`` [H, S] replaces the draw from
    ``generator``."""
    if samples is None:
        samples = sample_relative_pose(valid, generator, num_hypotheses, sample_size)

    def normalize(p, K):
        return torch.stack([(p[:, 0] - K[0, 2]) / K[0, 0], (p[:, 1] - K[1, 2]) / K[1, 1]], dim=1)

    p0n, p1n = normalize(pts0, K0), normalize(pts1, K1)
    f_mean = 0.25 * (K0[0, 0] + K0[1, 1] + K1[0, 0] + K1[1, 1])
    thr2 = (threshold_px / f_mean) ** 2

    Eh = _essential_8pt(p0n[samples], p1n[samples])  # [H, 3, 3]
    inl = (_sampson_normalized(Eh, p0n, p1n) <= thr2) & valid[None]
    finite = torch.isfinite(Eh).all(dim=-1).all(dim=-1)
    best = torch.argmax(torch.where(finite, inl.sum(dim=1), torch.full_like(finite, -1, dtype=torch.long)))
    # consensus refit on every inlier, then a second inlier pass
    E = _essential_8pt(p0n, p1n, inl[best].to(p0n.dtype))
    inliers = (_sampson_normalized(E, p0n, p1n) <= thr2) & valid

    # cheirality: the candidate with most inliers in front of both cameras
    Rs, ts = _decompose_E(E)
    n = p0n.shape[0]
    P0 = torch.eye(3, 4, dtype=E.dtype, device=E.device).expand(4, 3, 4)
    P1 = torch.cat([Rs, ts[..., None]], dim=-1)
    P = torch.stack([P0, P1], dim=1)[:, None].expand(4, n, 2, 3, 4).reshape(4 * n, 2, 3, 4)
    uv = torch.stack([p0n, p1n], dim=1)[None].expand(4, n, 2, 2).reshape(4 * n, 2, 2)
    both = torch.ones((4 * n, 2), dtype=torch.bool, device=E.device)
    xyz = triangulate_tracks(P, uv, both).reshape(4, n, 3)
    z1 = (xyz @ Rs.transpose(-1, -2) + ts[:, None])[..., 2]
    front = ((xyz[..., 2] > 0) & (z1 > 0) & inliers[None]).sum(dim=1)
    k = torch.argmax(front)
    num = inliers.sum().to(torch.int32)
    return RelativePose(R=Rs[k], t=ts[k], inliers=inliers, num_inliers=num, ok=num >= sample_size)
