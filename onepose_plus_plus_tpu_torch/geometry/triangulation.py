"""Multi-view triangulation: batched DLT + reprojection filtering (port of
``onepose_plus_plus_tpu/geometry/triangulation.py``).

The replacement for COLMAP's ``point_triangulator`` with poses fixed: every
feature track is one fixed-capacity row of a batched problem. Each view adds
the rows u P[2] - P[0] and v P[2] - P[1]; the point is the eigenvector of the
4 x 4 normal matrix with the smallest eigenvalue (``torch.linalg.eigh``,
batched). Acceptance follows COLMAP's defaults (triangulation angle 1.5 deg,
reprojection 4 px).
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-12
# cuSOLVER's batched symmetric eigensolver (torch 2.11, CUDA 12.8, H100)
# refuses large batches with CUSOLVER_STATUS_INVALID_VALUE (32768 4 x 4
# matrices fail, 16384 pass); the all-pairs hypotheses of one scene reach
# millions. eigh therefore runs over chunks of this many matrices.
EIGH_CHUNK = 8192


def projection_matrix(K: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """P = K [R | t]: [..., 3, 3] x [..., 4, 4] -> [..., 3, 4]."""
    return K @ T[..., :3, :4]


def triangulate_tracks(P: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """DLT over fixed-capacity tracks: P [T, V, 3, 4], uv [T, V, 2], valid
    [T, V] -> xyz [T, 3] (meaningless where fewer than 2 views are valid)."""
    w = valid.to(P.dtype)[..., None]
    r0 = uv[..., 0:1] * P[..., 2, :] - P[..., 0, :]
    r1 = uv[..., 1:2] * P[..., 2, :] - P[..., 1, :]
    r0 = r0 / (torch.linalg.norm(r0, dim=-1, keepdim=True) + _EPS) * w
    r1 = r1 / (torch.linalg.norm(r1, dim=-1, keepdim=True) + _EPS) * w
    A = torch.cat([r0, r1], dim=-2)  # [T, 2V, 4]
    AtA = torch.einsum("tva,tvb->tab", A, A)
    X = torch.cat([torch.linalg.eigh(m)[1][..., :, 0] for m in AtA.split(EIGH_CHUNK)])
    w4 = X[..., 3:4]
    return X[..., :3] / (w4 + torch.where(w4 >= 0, _EPS, -_EPS))


def triangulation_angles(centers: torch.Tensor, xyz: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Largest angle (radians) between two valid viewing rays of each track:
    centers [T, V, 3], xyz [T, 3], valid [T, V] -> [T]."""
    rays = centers - xyz[:, None, :]
    rays = rays / (torch.linalg.norm(rays, dim=-1, keepdim=True) + _EPS)
    cosang = torch.einsum("tvc,twc->tvw", rays, rays)
    v = valid.shape[-1]
    eye = torch.eye(v, dtype=torch.bool, device=valid.device)
    pair_ok = valid[:, :, None] & valid[:, None, :] & ~eye
    cosang = torch.where(pair_ok, cosang, torch.ones_like(cosang))
    return torch.arccos(cosang.amin(dim=(-2, -1)).clamp(-1.0, 1.0))


def _score_point(P, T, uv, valid, xyz, max_reproj_px):
    """Per-observation reprojection error, depth and inlier mask of xyz [Tr, 3]."""
    Xh = torch.cat([xyz, torch.ones_like(xyz[..., :1])], dim=-1)
    proj = torch.einsum("tvij,tj->tvi", P, Xh)
    depth = torch.einsum("tvij,tj->tvi", T[..., :3, :4], Xh)[..., 2]
    uv_hat = proj[..., :2] / (proj[..., 2:3] + _EPS)
    err = torch.linalg.norm(uv_hat - uv, dim=-1)
    return err, depth, valid & (err <= max_reproj_px) & (depth > _EPS)


def triangulate_and_filter(K, T, uv, valid, max_reproj_px: float = 4.0,
                           min_tri_angle_deg: float = 1.5):
    """Robust track triangulation with COLMAP's acceptance tests.

    Every pair of observations (V(V-1)/2 of them) is a two-view hypothesis,
    scored by its support (reprojection within the threshold, positive
    depth); the best one's consensus set is refit by the full DLT, and the
    hypothesis itself is kept where the refit lost support.

    Args:
        K: [Tr, V, 3, 3]; T: [Tr, V, 4, 4] world->cam; uv: [Tr, V, 2]; valid: [Tr, V].
    Returns:
        xyz [Tr, 3], obs_inlier [Tr, V], track_ok [Tr] (>= 2 inliers, angle
        above the threshold, finite), reproj_err [Tr, V] in px.
    """
    tr, v = valid.shape
    P = projection_matrix(K, T)
    ii, jj = torch.triu_indices(v, v, offset=1, device=valid.device)
    n_pairs = ii.shape[0]
    pair_P = torch.stack([P[:, ii], P[:, jj]], dim=2)  # [Tr, Np, 2, 3, 4]
    pair_uv = torch.stack([uv[:, ii], uv[:, jj]], dim=2)
    pair_valid = valid[:, ii] & valid[:, jj]
    both = torch.ones((tr * n_pairs, 2), dtype=torch.bool, device=valid.device)
    xyz_h = triangulate_tracks(pair_P.reshape(tr * n_pairs, 2, 3, 4),
                               pair_uv.reshape(tr * n_pairs, 2, 2), both).reshape(tr, n_pairs, 3)

    Xh = torch.cat([xyz_h, torch.ones_like(xyz_h[..., :1])], dim=-1)
    proj = torch.einsum("tvij,tnj->tnvi", P, Xh)
    depth_h = torch.einsum("tvij,tnj->tnvi", T[..., :3, :4], Xh)[..., 2]
    uv_hat = proj[..., :2] / (proj[..., 2:3] + _EPS)
    err_h = torch.linalg.norm(uv_hat - uv[:, None], dim=-1)
    support = valid[:, None, :] & (err_h <= max_reproj_px) & (depth_h > _EPS)  # [Tr, Np, V]
    counts = torch.where(pair_valid, support.sum(dim=-1), torch.full_like(pair_valid, -1, dtype=torch.long))
    best = torch.argmax(counts, dim=-1)  # first maximum, as jnp.argmax
    consensus = torch.gather(support, 1, best[:, None, None].expand(tr, 1, v))[:, 0]

    xyz = triangulate_tracks(P, uv, consensus)
    reproj_err, _, obs_inlier = _score_point(P, T, uv, valid, xyz, max_reproj_px)
    xyz_best = torch.gather(xyz_h, 1, best[:, None, None].expand(tr, 1, 3))[:, 0]
    err_b, _, inl_b = _score_point(P, T, uv, valid, xyz_best, max_reproj_px)
    use_refit = obs_inlier.sum(dim=-1) >= inl_b.sum(dim=-1)
    xyz = torch.where(use_refit[:, None], xyz, xyz_best)
    reproj_err = torch.where(use_refit[:, None], reproj_err, err_b)
    obs_inlier = torch.where(use_refit[:, None], obs_inlier, inl_b)

    centers = -torch.einsum("tvji,tvj->tvi", T[..., :3, :3], T[..., :3, 3])
    angle = triangulation_angles(centers, xyz, obs_inlier)
    track_ok = ((obs_inlier.sum(dim=-1) >= 2) & (angle >= math.radians(min_tri_angle_deg))
                & torch.isfinite(xyz).all(dim=-1))
    return xyz, obs_inlier, track_ok, reproj_err
