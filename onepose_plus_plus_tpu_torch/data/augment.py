"""Photometric augmentation registry for training images.

Behavioral port of reference ``src/utils/utils_phoaug.py:11-125``
(``build_augmentor`` with 'dark' / 'mobile' / 'YCB' / 'FDA' styles backed by
albumentations). Implemented in numpy so the host loader has no extra
dependencies; each augmentor maps a [H, W] float grayscale in [0, 1] to the
same shape.
"""
from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence

import numpy as np


def _rand_brightness_contrast(img, rng, b=0.4, c=0.3):
    alpha = 1.0 + rng.uniform(-c, c)
    beta = rng.uniform(-b, b)
    return np.clip(img * alpha + beta, 0.0, 1.0)


def _gauss_noise(img, rng, sigma_max=0.06):
    return np.clip(img + rng.normal(0, rng.uniform(0, sigma_max), img.shape), 0, 1)


def _motion_blur(img, rng, max_k=5):
    k = int(rng.integers(2, max_k + 1))
    horiz = rng.random() < 0.5
    kernel = np.ones(k) / k
    out = img.copy()
    if horiz:
        for i in range(img.shape[0]):
            out[i] = np.convolve(img[i], kernel, mode="same")
    else:
        for j in range(img.shape[1]):
            out[:, j] = np.convolve(img[:, j], kernel, mode="same")
    return out


def _iso_noise(img, rng):
    # luminance-dependent shot noise approximation
    sigma = rng.uniform(0.01, 0.05)
    return np.clip(img + rng.normal(0, sigma, img.shape) * np.sqrt(img + 1e-3), 0, 1)


class DarkAug:
    """Low-light style: strong brightness/contrast jitter + blur + noise
    (reference 'dark' augmentor)."""

    def __init__(self, seed: Optional[int] = None, p: float = 0.75):
        self.rng = np.random.default_rng(seed)
        self.p = p

    def __call__(self, img: np.ndarray) -> np.ndarray:
        rng = self.rng
        if rng.random() < self.p:
            img = _rand_brightness_contrast(img, rng, b=0.6, c=0.4)
        if rng.random() < 0.1:
            img = _motion_blur(img, rng, max_k=7)
        if rng.random() < 0.25:
            img = _gauss_noise(img, rng)
        return img


class MobileAug:
    """Mobile-capture style: motion blur + ISO noise (reference 'mobile')."""

    def __init__(self, seed: Optional[int] = None):
        self.rng = np.random.default_rng(seed)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        rng = self.rng
        if rng.random() < 0.25:
            img = _motion_blur(img, rng)
        if rng.random() < 0.25:
            img = _iso_noise(img, rng)
        if rng.random() < 0.5:
            img = _rand_brightness_contrast(img, rng)
        return img


def _gaussian_blur(img, rng, sigma_max=10.0, sigma_min=0.3):
    sigma = rng.uniform(sigma_min, sigma_max)
    radius = max(1, int(3 * sigma))
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    kernel = np.exp(-0.5 * (xs / sigma) ** 2)
    kernel /= kernel.sum()
    pad = ((radius, radius), (0, 0))
    out = np.pad(img, pad, mode="reflect")
    out = np.apply_along_axis(
        lambda col: np.convolve(col, kernel, mode="valid"), 0, out
    )
    out = np.pad(out, ((0, 0), (radius, radius)), mode="reflect")
    out = np.apply_along_axis(
        lambda row: np.convolve(row, kernel, mode="valid"), 1, out
    )
    return out.astype(img.dtype)


class YCBAug:
    """YCB-video rendering style: heavy sensor noise + blur (reference
    ``YCBAug``: ISONoise(0.4-0.9, p=.25), GaussNoise(var 100-300 on the 0-255
    scale, p=.7), GaussianBlur(sigma<=10, p=.7))."""

    def __init__(self, seed: Optional[int] = None):
        self.rng = np.random.default_rng(seed)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        rng = self.rng
        if rng.random() < 0.25:
            img = _iso_noise(img, rng)
        if rng.random() < 0.7:
            # var_limit (100, 300) on uint8 -> sigma 10-17.3 / 255 in [0, 1]
            sigma = np.sqrt(rng.uniform(100.0, 300.0)) / 255.0
            img = np.clip(img + rng.normal(0.0, sigma, img.shape), 0.0, 1.0)
        if rng.random() < 0.7:
            img = _gaussian_blur(img, rng, sigma_max=10.0)
        return img


def fda_transfer(src: np.ndarray, ref: np.ndarray, beta: float) -> np.ndarray:
    """Fourier Domain Adaptation: swap the centered low-frequency amplitude
    spectrum of ``src`` with ``ref``'s (band half-width ``floor(beta *
    min(H, W))``), keeping ``src``'s phase. Reference ``Stylization`` uses
    albumentations ``A.FDA`` with ``beta_limit=0.05``."""
    h, w = src.shape
    if ref.shape != src.shape:
        # nearest-neighbor resize of the style reference (appearance donor
        # only, so interpolation quality is irrelevant)
        ys = (np.arange(h) * ref.shape[0] / h).astype(int)
        xs = (np.arange(w) * ref.shape[1] / w).astype(int)
        ref = ref[ys][:, xs]
    b = int(np.floor(min(h, w) * beta))
    if b < 1:
        return src
    fs = np.fft.fft2(src)
    fr = np.fft.fft2(ref)
    amp = np.fft.fftshift(np.abs(fs))
    amp_r = np.fft.fftshift(np.abs(fr))
    cy, cx = h // 2, w // 2
    amp[cy - b : cy + b, cx - b : cx + b] = amp_r[cy - b : cy + b, cx - b : cx + b]
    amp = np.fft.ifftshift(amp)
    out = np.fft.ifft2(amp * np.exp(1j * np.angle(fs))).real
    return np.clip(out, 0.0, 1.0).astype(src.dtype)


class FDAAug:
    """FDA stylization toward a pool of reference images (reference
    ``Stylization(method='FDA')``: random reference per call, beta sampled
    in (0, beta_limit], applied with probability p)."""

    def __init__(
        self,
        ref_images: Optional[Sequence[np.ndarray]] = None,
        ref_root: Optional[str] = None,
        beta_limit: float = 0.05,
        p: float = 0.5,
        seed: Optional[int] = None,
    ):
        self.rng = np.random.default_rng(seed)
        self.beta_limit = beta_limit
        self.p = p
        imgs: List[np.ndarray] = list(ref_images or [])
        if ref_root:
            from .image_io import imread_gray

            for root, _dirs, files in os.walk(ref_root):
                for f in sorted(files):
                    if f.lower().endswith((".png", ".jpg", ".jpeg")):
                        imgs.append(imread_gray(os.path.join(root, f)))
        if not imgs:
            raise ValueError("FDA stylization needs ref_images or ref_root")
        self.ref_images = imgs

    def __call__(self, img: np.ndarray) -> np.ndarray:
        rng = self.rng
        if rng.random() >= self.p:
            return img
        ref = self.ref_images[int(rng.integers(len(self.ref_images)))]
        beta = rng.uniform(0.0, self.beta_limit)
        return fda_transfer(img, ref, beta)


def build_augmentor(
    method: Optional[str] = None, seed: Optional[int] = None, **kwargs
) -> Optional[Callable]:
    """Registry mirroring the reference's ``build_augmentor`` names
    (``utils_phoaug.py:108-121``: dark / mobile / FDA; plus the in-tree but
    unregistered YCBAug)."""
    if method is None or method in ("none", "None"):
        return None
    if method == "dark":
        return DarkAug(seed)
    if method == "mobile":
        return MobileAug(seed)
    if method in ("YCB", "ycb"):
        return YCBAug(seed)
    if method == "FDA":
        return FDAAug(seed=seed, **kwargs)
    raise ValueError(f"Invalid augmentation method: {method}")
