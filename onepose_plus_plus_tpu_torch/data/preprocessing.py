"""Host-side preprocessing: bbox crops with intrinsic updates, fixed-capacity
point-cloud padding, and SfM annotation (npz/json) IO.

Replaces reference ``src/utils/data_utils.py`` (crop/resize/K math :239-299,
``pad_features3d_random`` / ``build_features3d_leaves`` capacity padding
:93-237) and the annotation save/load side of
``src/sfm_utils/postprocess/feature_process.py`` (anno_3d_average.npz with
``keypoints3d [m, 3]``, ``descriptors3d [dim, m]``, ``scores3d [m, 1]``).

Everything here produces fixed shapes for the device pipeline: the point cloud
is always padded/subsampled to ``shape3d`` slots with a validity mask.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

try:
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False


# ------------------------------- crops -------------------------------------


def square_bbox(bbox_xyxy: np.ndarray, pad_ratio: float = 0.0) -> np.ndarray:
    """Expand a bbox to a square around its center (+ optional padding)."""
    x0, y0, x1, y1 = [float(v) for v in bbox_xyxy]
    cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
    half = max(x1 - x0, y1 - y0) * (1 + pad_ratio) / 2
    return np.array([cx - half, cy - half, cx + half, cy + half])


def crop_img_by_bbox(
    img: np.ndarray,
    bbox_xyxy: np.ndarray,
    K: Optional[np.ndarray] = None,
    out_size: int = 512,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Crop a bbox (may exceed image bounds) and resize to out_size^2.

    Mirrors reference ``LocalFeatureObjectDetector.crop_img_by_bbox``
    (``local_feature_2D_detector.py:133-159``): an affine warp so out-of-bound
    regions are zero-filled, plus the matching intrinsic update.

    Returns (crop [out, out] float, K_crop or None).
    """
    x0, y0, x1, y1 = [float(v) for v in bbox_xyxy]
    sx = out_size / (x1 - x0)
    sy = out_size / (y1 - y0)
    A = np.array([[sx, 0, -x0 * sx], [0, sy, -y0 * sy]], dtype=np.float64)
    if _HAS_CV2:
        crop = cv2.warpAffine(
            img, A, (out_size, out_size), flags=cv2.INTER_LINEAR
        )
    else:  # pragma: no cover — pure-numpy nearest fallback
        ys, xs = np.mgrid[0:out_size, 0:out_size]
        src_x = np.clip((xs / sx + x0).astype(int), 0, img.shape[1] - 1)
        src_y = np.clip((ys / sy + y0).astype(int), 0, img.shape[0] - 1)
        crop = img[src_y, src_x]
        oob = (xs / sx + x0 < 0) | (xs / sx + x0 >= img.shape[1]) | (
            ys / sy + y0 < 0
        ) | (ys / sy + y0 >= img.shape[0])
        crop = np.where(oob, 0, crop)
    K_crop = None
    if K is not None:
        K_crop = K.copy().astype(np.float64)
        K_crop[0, 0] *= sx
        K_crop[1, 1] *= sy
        K_crop[0, 2] = (K[0, 2] - x0) * sx
        K_crop[1, 2] = (K[1, 2] - y0) * sy
    return crop, K_crop


# -------------------------- point-cloud capacity ----------------------------


def pad_point_cloud(
    keypoints3d: np.ndarray,
    descriptors3d: np.ndarray,
    scores3d: Optional[np.ndarray],
    shape3d: int,
    rng: Optional[np.ndarray] = None,
    keep_idx: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Pad / subsample a point cloud to exactly ``shape3d`` slots.

    Reference semantics (``data_utils.py:93-237``): if fewer points than
    capacity, fill with random-uniform fake points (descriptors zero); if
    more, random-subsample — but always keep ``keep_idx`` (the GT-assigned
    points during training) first.

    Args:
        keypoints3d: [m, 3]; descriptors3d: [m, D]; scores3d: [m] or None.
        rng: np.random.Generator (default: fresh deterministic).
        keep_idx: indices that must survive subsampling.
    Returns:
        dict(keypoints3d [S, 3], descriptors3d [S, D], scores3d [S],
             valid [S] bool, orig_idx [S] int — -1 for padded slots).
    """
    gen = rng if rng is not None else np.random.default_rng(0)
    m, d = descriptors3d.shape
    if scores3d is None:
        scores3d = np.ones((m,), np.float32)
    scores3d = scores3d.reshape(m)

    if m >= shape3d:
        if keep_idx is not None and len(keep_idx) > 0:
            keep = np.unique(np.asarray(keep_idx))[:shape3d]
            rest = np.setdiff1d(np.arange(m), keep, assume_unique=False)
            n_fill = shape3d - len(keep)
            fill = gen.choice(rest, size=n_fill, replace=False)
            idx = np.concatenate([keep, fill])
        else:
            idx = gen.choice(m, size=shape3d, replace=False)
        return {
            "keypoints3d": keypoints3d[idx].astype(np.float32),
            "descriptors3d": descriptors3d[idx].astype(np.float32),
            "scores3d": scores3d[idx].astype(np.float32),
            "valid": np.ones(shape3d, bool),
            "orig_idx": idx.astype(np.int64),
        }

    n_pad = shape3d - m
    lo = keypoints3d.min(axis=0) if m else np.zeros(3)
    hi = keypoints3d.max(axis=0) if m else np.ones(3)
    fake_pts = gen.uniform(lo, hi, (n_pad, 3)).astype(np.float32)
    return {
        "keypoints3d": np.concatenate(
            [keypoints3d.astype(np.float32), fake_pts]
        ),
        "descriptors3d": np.concatenate(
            [descriptors3d.astype(np.float32), np.zeros((n_pad, d), np.float32)]
        ),
        "scores3d": np.concatenate(
            [scores3d.astype(np.float32), np.zeros(n_pad, np.float32)]
        ),
        "valid": np.concatenate([np.ones(m, bool), np.zeros(n_pad, bool)]),
        "orig_idx": np.concatenate(
            [np.arange(m, dtype=np.int64), np.full(n_pad, -1, np.int64)]
        ),
    }


# ----------------------------- annotations ----------------------------------


def save_3d_annotation(
    path: str,
    keypoints3d: np.ndarray,
    descriptors3d: np.ndarray,
    scores3d: np.ndarray,
) -> None:
    """Write anno_3d_average.npz in the reference's layout: descriptors are
    stored transposed [D, m] (``feature_process.py`` save_3d_anno)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(
        path,
        keypoints3d=keypoints3d.astype(np.float32),
        descriptors3d=np.ascontiguousarray(descriptors3d.T).astype(np.float32),
        scores3d=scores3d.reshape(-1, 1).astype(np.float32),
    )


def load_3d_annotation(path: str) -> Dict[str, np.ndarray]:
    """Read anno_3d_average.npz -> dict with descriptors back in [m, D]."""
    with np.load(path) as z:
        return {
            "keypoints3d": z["keypoints3d"].astype(np.float32),
            "descriptors3d": z["descriptors3d"].T.astype(np.float32),
            "scores3d": z["scores3d"].reshape(-1).astype(np.float32),
        }


def save_2d_annotation(path: str, entries: list) -> None:
    """Write per-image 2D-3D assignment annotations (anno_2d.json layout)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(entries, f)


def load_2d_annotation(path: str) -> list:
    with open(path) as f:
        return json.load(f)
