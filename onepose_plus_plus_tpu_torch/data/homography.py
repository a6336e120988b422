"""Homography sampling + warping for train-time view adaptation.

Port of the reference's scale-affine-perspective homography augmentation
(``src/utils/sample_homo.py`` ``sample_homography_sap``, used by
``OnePosePlus_dataset.py`` ``image_warp_adapt`` to double the train set with
warped copies). Host-side: image warps are data prep, the device never sees
dynamic shapes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

try:
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False


def sample_homography(
    h: int,
    w: int,
    rng: Optional[np.random.Generator] = None,
    perspective_amplitude: float = 0.15,
    scaling_amplitude: float = 0.15,
    rotation_amplitude_deg: float = 15.0,
    translation_amplitude: float = 0.1,
) -> np.ndarray:
    """Sample a random scale-affine-perspective homography [3, 3] in pixels.

    Composition (like the reference SAP sampler): center -> random
    perspective skew + rotation + anisotropic scale + translation -> decenter.
    The transform maps original pixel coords to warped pixel coords.
    """
    gen = rng if rng is not None else np.random.default_rng()
    cx, cy = w / 2.0, h / 2.0
    T_center = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], np.float64)
    T_back = np.array([[1, 0, cx], [0, 1, cy], [0, 0, 1]], np.float64)

    ang = np.deg2rad(gen.uniform(-rotation_amplitude_deg, rotation_amplitude_deg))
    sx = 1.0 + gen.uniform(-scaling_amplitude, scaling_amplitude)
    sy = 1.0 + gen.uniform(-scaling_amplitude, scaling_amplitude)
    tx = gen.uniform(-translation_amplitude, translation_amplitude) * w
    ty = gen.uniform(-translation_amplitude, translation_amplitude) * h
    p1 = gen.uniform(-perspective_amplitude, perspective_amplitude) / max(w, h)
    p2 = gen.uniform(-perspective_amplitude, perspective_amplitude) / max(w, h)

    A = np.array(
        [
            [sx * np.cos(ang), -sy * np.sin(ang), tx],
            [sx * np.sin(ang), sy * np.cos(ang), ty],
            [p1, p2, 1.0],
        ],
        np.float64,
    )
    return T_back @ A @ T_center


def warp_image(
    img: np.ndarray, H: np.ndarray, out_hw: Optional[Tuple[int, int]] = None
) -> np.ndarray:
    """Warp [H, W] (or [H, W, C]) by homography H (orig -> warped coords)."""
    h, w = img.shape[:2]
    oh, ow = out_hw if out_hw else (h, w)
    if _HAS_CV2:
        return cv2.warpPerspective(img, H.astype(np.float64), (ow, oh))
    # pure-numpy inverse-map nearest fallback  # pragma: no cover
    Hi = np.linalg.inv(H)
    ys, xs = np.mgrid[0:oh, 0:ow]
    pts = np.stack([xs, ys, np.ones_like(xs)], axis=-1).reshape(-1, 3)
    src = pts @ Hi.T
    src = src[:, :2] / src[:, 2:3]
    sx = np.clip(np.round(src[:, 0]).astype(int), 0, w - 1)
    sy = np.clip(np.round(src[:, 1]).astype(int), 0, h - 1)
    out = img[sy, sx].reshape(oh, ow, *img.shape[2:])
    oob = (
        (src[:, 0] < 0) | (src[:, 0] >= w) | (src[:, 1] < 0) | (src[:, 1] >= h)
    ).reshape(oh, ow)
    out[oob] = 0
    return out


def warp_points(pts: np.ndarray, H: np.ndarray) -> np.ndarray:
    """Apply homography to [N, 2] pixel points."""
    ph = np.concatenate([pts, np.ones((len(pts), 1))], axis=1) @ H.T
    return ph[:, :2] / ph[:, 2:3]
