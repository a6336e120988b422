"""Match figures of the SfM gallery and the training callbacks, drawn with
cv2 and numpy (no matplotlib): the port's counterparts of
``plot_image_pair_matches`` and ``plot_reprojection_comparison`` in
``onepose_plus_plus_tpu/utils/plotting.py``. Each returns the figure as an
[H, W, 3] uint8 RGB array: the same geometry and colours as the matplotlib
figures (gray images, viridis-coloured match lines, lime points, yellow
whiskers), not their pixels.
"""
from __future__ import annotations

from typing import Optional

import cv2
import numpy as np

# matplotlib's viridis at its 256 entries, RGB, rounded to uint8
_VIRIDIS_HEX = (
    "44015444025645045745055946075a46085c460a5d460b5e470d60470e61471063471164471365481467481668481769"
    "48186a481a6c481b6d481c6e481d6f481f70482071482173482374482475482576482677482878482979472a7a472c7a"
    "472d7b472e7c472f7d46307e46327e46337f463480453581453781453882443983443a83443b84433d84433e85423f85"
    "4240864241864142874144874045884046883f47883f48893e49893e4a893e4c8a3d4d8a3d4e8a3c4f8a3c508b3b518b"
    "3b528b3a538b3a548c39558c39568c38588c38598c375a8c375b8d365c8d365d8d355e8d355f8d34608d34618d33628d"
    "33638d32648e32658e31668e31678e31688e30698e306a8e2f6b8e2f6c8e2e6d8e2e6e8e2e6f8e2d708e2d718e2c718e"
    "2c728e2c738e2b748e2b758e2a768e2a778e2a788e29798e297a8e297b8e287c8e287d8e277e8e277f8e27808e26818e"
    "26828e26828e25838e25848e25858e24868e24878e23888e23898e238a8d228b8d228c8d228d8d218e8d218f8d21908d"
    "21918c20928c20928c20938c1f948c1f958b1f968b1f978b1f988b1f998a1f9a8a1e9b8a1e9c891e9d891f9e891f9f88"
    "1fa0881fa1881fa1871fa28720a38620a48621a58521a68522a78522a88423a98324aa8325ab8225ac8226ad8127ad81"
    "28ae8029af7f2ab07f2cb17e2db27d2eb37c2fb47c31b57b32b67a34b67935b77937b87838b9773aba763bbb753dbc74"
    "3fbc7340bd7242be7144bf7046c06f48c16e4ac16d4cc26c4ec36b50c46a52c56954c56856c66758c7655ac8645cc863"
    "5ec96260ca6063cb5f65cb5e67cc5c69cd5b6ccd5a6ece5870cf5773d05675d05477d1537ad1517cd2507fd34e81d34d"
    "84d44b86d54989d5488bd6468ed64590d74393d74195d84098d83e9bd93c9dd93ba0da39a2da37a5db36a8db34aadc32"
    "addc30b0dd2fb2dd2db5de2bb8de29bade28bddf26c0df25c2df23c5e021c8e020cae11fcde11dd0e11cd2e21bd5e21a"
    "d8e219dae319dde318dfe318e2e418e5e419e7e419eae51aece51befe51cf1e51df4e61ef6e620f8e621fbe723fde725"
)
VIRIDIS = np.frombuffer(bytes.fromhex(_VIRIDIS_HEX), np.uint8).reshape(256, 3)
LIME, YELLOW, RED = (0, 255, 0), (255, 255, 0), (255, 0, 0)
PAIR_GAP = 10  # white columns between the two images of a pair
TITLE_ROWS = 24  # the white band above the reprojection figure's image


def viridis(values: np.ndarray) -> np.ndarray:
    """[N] values in [0, 1] -> [N, 3] uint8 RGB, indexed as matplotlib's
    colormaps index a float (floor(256 v), clipped)."""
    idx = np.clip(np.floor(np.asarray(values, np.float64) * 256), 0, 255).astype(np.int64)
    return VIRIDIS[idx]


def _gray_rgb(image: np.ndarray) -> np.ndarray:
    """[H, W] or [H, W, 1] image -> [H, W, 3] uint8, scaled from its own
    minimum and maximum as ``imshow(cmap="gray")`` scales a float image."""
    img = np.asarray(image).squeeze()
    if img.dtype != np.uint8:
        img = img.astype(np.float64)
        lo, hi = float(img.min()), float(img.max())
        img = np.round(255 * (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)).astype(np.uint8)
    return np.repeat(img[..., None], 3, axis=2)


def _px(p) -> tuple:
    return int(round(float(p[0]))), int(round(float(p[1])))


def _finite(*arrays) -> np.ndarray:
    return np.all([np.isfinite(np.asarray(a, np.float64)).all(axis=1) for a in arrays], axis=0)


def plot_image_pair_matches(
    image0: np.ndarray,
    image1: np.ndarray,
    mkpts0: np.ndarray,
    mkpts1: np.ndarray,
    mconf: Optional[np.ndarray] = None,
    max_lines: int = 150,
) -> np.ndarray:
    """The pair side by side in gray (``PAIR_GAP`` white columns between),
    lime points at the first ``max_lines`` matches' ends and a line for each,
    coloured by its confidence through viridis (lime without ``mconf``),
    drawn over the points. Returns [max(H0, H1), W0 + PAIR_GAP + W1, 3]
    uint8 RGB."""
    g0, g1 = _gray_rgb(image0), _gray_rgb(image1)
    (h0, w0), (h1, w1) = g0.shape[:2], g1.shape[:2]
    out = np.full((max(h0, h1), w0 + PAIR_GAP + w1, 3), 255, np.uint8)
    out[:h0, :w0] = g0
    out[:h1, w0 + PAIR_GAP:] = g1
    n = min(len(mkpts0), max_lines)
    p0, p1 = np.asarray(mkpts0, np.float64)[:n], np.asarray(mkpts1, np.float64)[:n] + [w0 + PAIR_GAP, 0]
    colors = viridis(np.asarray(mconf)[:n]) if mconf is not None else np.tile(LIME, (n, 1))
    keep = np.flatnonzero(_finite(p0, p1))
    for i in keep:
        cv2.circle(out, _px(p0[i]), 2, LIME, -1)
        cv2.circle(out, _px(p1[i]), 2, LIME, -1)
    for i in keep:
        cv2.line(out, _px(p0[i]), _px(p1[i]), tuple(int(c) for c in colors[i]), 1, cv2.LINE_8)
    return out


def plot_reprojection_comparison(
    image: np.ndarray,
    mkpts_pred: np.ndarray,
    mkpts_gt_proj: np.ndarray,
    title: str = "",
    max_points: int = 200,
) -> np.ndarray:
    """Predicted matches against their GT-pose projections (the reference's
    reprojection TB figure): the image in gray under a ``TITLE_ROWS`` white
    band that holds the title with the mean reprojection error and the
    legend; for the first ``max_points`` matches a yellow whisker from the
    prediction to its projection, a lime point at the prediction and a red
    one at the projection. Returns [H + TITLE_ROWS, W, 3] uint8 RGB."""
    g = _gray_rgb(image)
    h, w = g.shape[:2]
    out = np.full((h + TITLE_ROWS, w, 3), 255, np.uint8)
    out[TITLE_ROWS:] = g
    n = min(len(mkpts_pred), max_points)
    pred, gt = np.asarray(mkpts_pred, np.float64)[:n], np.asarray(mkpts_gt_proj, np.float64)[:n]
    err = float(np.mean(np.linalg.norm(pred - gt, axis=1))) if n else float("nan")
    shift = np.array([0, TITLE_ROWS])
    keep = np.flatnonzero(_finite(pred, gt))
    for i in keep:
        cv2.line(out, _px(pred[i] + shift), _px(gt[i] + shift), YELLOW, 1, cv2.LINE_8)
    for i in keep:
        cv2.circle(out, _px(pred[i] + shift), 1, LIME, -1)
        cv2.circle(out, _px(gt[i] + shift), 1, RED, -1)
    font = cv2.FONT_HERSHEY_SIMPLEX
    cv2.putText(out, f"{title} mean reproj err {err:.2f}px".strip(), (4, 16), font, 0.45, (0, 0, 0), 1, cv2.LINE_AA)
    if n:
        cv2.putText(out, "pred", (w - 90, 16), font, 0.4, LIME, 1, cv2.LINE_AA)
        cv2.putText(out, "GT proj", (w - 52, 16), font, 0.4, RED, 1, cv2.LINE_AA)
    return out
