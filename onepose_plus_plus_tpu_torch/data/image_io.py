"""Host-side image loading, resizing, padding, and artifact IO.

Replaces reference ``src/utils/data_io.py`` (grayscale read with
divisibility-8 resize, square padding with masks, h5 dict IO). Decoding stays
on host (cv2/PIL are data prep, not the hot path — SURVEY.md §2.4); everything
returned is a numpy array shaped for the fixed-shape device pipeline:
images are HWC float32 in [0, 1] with channel dim 1.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

try:  # cv2 is the fast path; PIL fallback keeps the module importable anywhere
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False
    from PIL import Image as _PILImage


def imread_gray(path: str) -> np.ndarray:
    """Read an image as float32 grayscale [H, W] in [0, 1]."""
    if _HAS_CV2:
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(path)
    else:  # pragma: no cover
        img = np.asarray(_PILImage.open(path).convert("L"))
    return img.astype(np.float32) / 255.0


def imread_color(path: str) -> np.ndarray:
    """Read an image as uint8 RGB [H, W, 3]."""
    if _HAS_CV2:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return img[..., ::-1].copy()
    return np.asarray(_PILImage.open(path).convert("RGB"))  # pragma: no cover


def resize_image(
    img: np.ndarray, new_hw: Tuple[int, int]
) -> np.ndarray:
    """Resize [H, W] or [H, W, C] to (new_h, new_w) with area/linear interp."""
    h, w = img.shape[:2]
    nh, nw = new_hw
    if (h, w) == (nh, nw):
        return img
    if _HAS_CV2:
        interp = cv2.INTER_AREA if nh < h else cv2.INTER_LINEAR
        return cv2.resize(img, (nw, nh), interpolation=interp)
    arr = _PILImage.fromarray(  # pragma: no cover
        (img * 255).astype(np.uint8) if img.dtype != np.uint8 else img
    ).resize((nw, nh))
    out = np.asarray(arr)  # pragma: no cover
    return out.astype(img.dtype) / (255.0 if img.dtype != np.uint8 else 1)


def round_to_divisible(size: int, df: int = 8) -> int:
    """Largest multiple of df not exceeding size (reference df-8 semantics)."""
    return max(df, (size // df) * df)


def load_gray_resize_divisible(
    path: str,
    resize_max: Optional[int] = None,
    df: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """Load grayscale, optionally cap the long side, snap H/W to df multiples.

    Mirrors the reference SfM pair loader (``loftr_coarse_dataset.py:12-76``):
    images enter LoFTR at (near-)original size but with both dimensions
    divisible by the coarse stride.

    Returns:
        img: [H', W'] float32; scale: [2] (w_orig/w_new, h_orig/h_new) to map
        matcher outputs back into original pixel coordinates.
    """
    img = imread_gray(path)
    h, w = img.shape
    if resize_max is not None and max(h, w) > resize_max:
        s = resize_max / max(h, w)
        nh, nw = int(round(h * s)), int(round(w * s))
    else:
        nh, nw = h, w
    nh, nw = round_to_divisible(nh, df), round_to_divisible(nw, df)
    out = resize_image(img, (nh, nw))
    scale = np.array([w / nw, h / nh], dtype=np.float32)
    return out, scale


def pad_to_shape(
    img: np.ndarray, hw: Tuple[int, int]
) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad bottom/right to (H, W); return (padded, valid_mask)."""
    h, w = img.shape[:2]
    ph, pw = hw
    out = np.zeros((ph, pw) + img.shape[2:], dtype=img.dtype)
    out[:h, :w] = img
    mask = np.zeros((ph, pw), dtype=bool)
    mask[:h, :w] = True
    return out, mask


def save_h5(data: Dict[str, np.ndarray], path: str) -> None:
    """Write a flat dict of arrays to an HDF5 file (hloc-style artifacts)."""
    import h5py

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w") as f:
        for k, v in data.items():
            f.create_dataset(k, data=v)


def load_h5(path: str) -> Dict[str, np.ndarray]:
    """Read a flat dict of arrays from an HDF5 file."""
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = obj[()]

        f.visititems(visit)
    return out


def grouped_save_h5(data: Dict[str, Dict[str, np.ndarray]], path: str) -> None:
    """Write a two-level dict {group: {key: array}} (per-image features h5)."""
    import h5py

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w") as f:
        for g, sub in data.items():
            grp = f.create_group(g)
            for k, v in sub.items():
                grp.create_dataset(k, data=v)


def grouped_load_h5(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Read a two-level dict written by :func:`grouped_save_h5`."""
    import h5py

    out: Dict[str, Dict[str, np.ndarray]] = {}
    with h5py.File(path, "r") as f:
        for g in f.keys():
            out[g] = {k: f[g][k][()] for k in f[g].keys()}
    return out
