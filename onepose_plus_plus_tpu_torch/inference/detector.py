"""Local-feature object detection: the bbox for the first frame and after a lost track.

Port of ``onepose_plus_plus_tpu/inference/detector.py`` (reference
``src/local_feature_object_detector/local_feature_2D_detector.py:37-226``):
DB views sampled from the SfM model are matched against the full query frame
by LoFTR's ``match_coarse`` (one batched forward over all views), an affine
transform per view is fitted by RANSAC (the ``cv2.estimateAffine2D``
replacement, batched over views), the DB image corners are projected into the
query and the view with the most inliers gives the bbox; a centered box when
matching fails; while tracking, the 3D box projected with the previous pose.

RANSAC draws its minimal samples by Gumbel top-k from an explicit
``torch.Generator`` (JAX draws them from its keys, which torch cannot
reproduce); ``sample_idx`` feeds given samples instead, so that tests hand
both packages the same ones.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..data.preprocessing import crop_img_by_bbox, square_bbox

_EPS = 1e-9


def _fit_affine(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Least-squares affine A [..., 2, 3] from src [..., S, 2] -> dst [..., S, 2]."""
    X = torch.cat([src, torch.ones_like(src[..., :1])], dim=-1)  # [..., S, 3]
    XtX = X.transpose(-1, -2) @ X + 1e-6 * torch.eye(3, dtype=src.dtype, device=src.device)
    # solve_ex: a degenerate sample gives non-finite A, dropped by the caller
    At = torch.linalg.solve_ex(XtX, X.transpose(-1, -2) @ dst)[0]  # [..., 3, 2]
    return At.transpose(-1, -2)


def ransac_affine(
    src: torch.Tensor,
    dst: torch.Tensor,
    valid: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    inlier_threshold_px: float = 4.0,
    num_hypotheses: int = 256,
    sample_size: int = 3,
    sample_idx: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RANSAC 2D affine fit, batched over views (``cv2.estimateAffine2D`` equivalent).

    Args:
        src, dst: [V, N, 2]; valid: [V, N] bool.
        generator: draws the minimal samples (Gumbel top-k over the valid
            points) on its device; unused when ``sample_idx`` [V, H, S] gives them.
    Returns:
        (A [V, 2, 3], inliers [V, N] bool, num_inliers [V] int32).
    """
    v, n = valid.shape
    if sample_idx is None:
        u = torch.rand((v, num_hypotheses, n), generator=generator, device=src.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        scores = torch.where(valid[:, None, :], gumbel, torch.full_like(gumbel, -torch.inf))
        sample_idx = scores.topk(sample_size, dim=-1).indices  # [V, H, S]
    take = lambda pts: torch.gather(  # noqa: E731  [V, N, 2] -> [V, H, S, 2]
        pts[:, None].expand(v, sample_idx.shape[1], n, 2), 2, sample_idx[..., None].expand(-1, -1, -1, 2))
    A_h = _fit_affine(take(src), take(dst))  # [V, H, 2, 3]

    X = torch.cat([src, torch.ones_like(src[..., :1])], dim=-1)  # [V, N, 3]
    pred = torch.einsum("vhij,vnj->vhni", A_h, X)  # [V, H, N, 2]
    err = torch.linalg.norm(pred - dst[:, None], dim=-1)
    inl = (err <= inlier_threshold_px) & valid[:, None]
    counts = inl.sum(dim=-1)
    finite = torch.isfinite(A_h).all(dim=-1).all(dim=-1)
    counts = torch.where(finite, counts, torch.full_like(counts, -1))
    best = counts.argmax(dim=-1)  # the first of equal counts, as jnp.argmax
    # refit on the best consensus set (weighted least squares)
    w = inl[torch.arange(v, device=src.device), best].to(src.dtype)  # [V, N]
    Xw = X * w[..., None]
    XtX = Xw.transpose(-1, -2) @ X + 1e-6 * torch.eye(3, dtype=src.dtype, device=src.device)
    At = torch.linalg.solve_ex(XtX, Xw.transpose(-1, -2) @ dst)[0]  # [V, 3, 2]
    err_f = torch.linalg.norm(X @ At - dst, dim=-1)
    inl_f = (err_f <= inlier_threshold_px) & valid
    return At.transpose(-1, -2), inl_f, inl_f.sum(dim=-1).to(torch.int32)


class LocalFeatureObjectDetector:
    """Detect the object bbox in a full query frame by matching DB views."""

    def __init__(
        self,
        matcher_coarse_fn: Callable,
        db_images: np.ndarray,  # [V, H, W] grayscale network-resolution DB views
        output_size: int = 512,
        detect_threshold_px: float = 4.0,
        min_matches: int = 6,
    ):
        """Args:
        matcher_coarse_fn: (img0 [B,H,W,1], img1 [B,H',W',1]) numpy ->
            coarse-match dict (``models.build.make_loftr_fns``' first
            surface); img0 are the DB views, img1 the tiled query.
        db_images: reference views sampled from the SfM model images (the
            reference samples ~15, ``local_feature_2D_detector.py:37``).
        """
        self.matcher_coarse_fn = matcher_coarse_fn
        self.db_images = db_images
        self.output_size = output_size
        self.detect_threshold_px = detect_threshold_px
        self.min_matches = min_matches

    def detect_bbox(self, query: np.ndarray, generator: torch.Generator) -> Tuple[np.ndarray, int]:
        """Best bbox [x0, y0, x1, y1] in query pixels and its inlier count.

        One batched LoFTR forward over all DB views (uploaded with the query on
        every call, as the JAX detector does), then the views' affine RANSACs
        on the generator's device; the view with the most inliers wins
        (reference ``detect_by_matching``).
        """
        v, dh, dw = self.db_images.shape
        img0 = self.db_images[..., None].astype(np.float32)
        img1 = np.tile(query[None, ..., None].astype(np.float32), (v, 1, 1, 1))
        res = self.matcher_coarse_fn(img0, img1)
        dev = generator.device
        A, _, counts = ransac_affine(
            res["mkpts0_c"].to(dev), res["mkpts1_c"].to(dev), res["match_mask"].to(dev).bool(), generator,
            inlier_threshold_px=self.detect_threshold_px,
        )
        counts = counts.cpu().numpy()
        best = int(np.argmax(counts))
        n_inl = int(counts[best])
        if n_inl < self.min_matches:
            # centered fallback box (reference :84-91)
            h, w = query.shape
            half = min(h, w) // 2
            cx, cy = w // 2, h // 2
            return np.array([cx - half, cy - half, cx + half, cy + half], np.float64), n_inl
        corners = np.array([[0, 0, 1], [dw, 0, 1], [dw, dh, 1], [0, dh, 1]], np.float64)
        proj = corners @ A[best].double().cpu().numpy().T  # [4, 2]
        x0, y0 = proj.min(axis=0)
        x1, y1 = proj.max(axis=0)
        return np.array([x0, y0, x1, y1]), n_inl

    def detect(self, query: np.ndarray, K: np.ndarray,
               generator: torch.Generator) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """Detect, square-crop and resize; returns (crop, K_crop, bbox, inliers)."""
        bbox, n_inl = self.detect_bbox(query, generator)
        bbox_sq = square_bbox(bbox)
        crop, K_crop = crop_img_by_bbox(query, bbox_sq, K, self.output_size)
        return crop, K_crop, bbox_sq, n_inl

    def previous_pose_detect(self, query: np.ndarray, K: np.ndarray, pose_prev: np.ndarray,
                             box_corners_3d: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Tracking-mode bbox: the object's 3D box projected with the previous
        frame's pose (reference ``previous_pose_detect``)."""
        pc = box_corners_3d @ pose_prev[:3, :3].T + pose_prev[:3, 3]
        uv = (pc @ K.T)[:, :2] / np.clip((pc @ K.T)[:, 2:3], _EPS, None)
        x0, y0 = uv.min(axis=0)
        x1, y1 = uv.max(axis=0)
        bbox_sq = square_bbox(np.array([x0, y0, x1, y1]))
        crop, K_crop = crop_img_by_bbox(query, bbox_sq, K, self.output_size)
        return crop, K_crop, bbox_sq
