"""Match figures of the SfM gallery and the training callbacks (the port's
own copies of ``plot_image_pair_matches``, ``plot_reprojection_comparison``
and ``figure_to_array`` from ``onepose_plus_plus_tpu/utils/plotting.py``). matplotlib is imported when a
figure is drawn, not with the module."""
from __future__ import annotations

from typing import Optional

import numpy as np


def _require_plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_reprojection_comparison(
    image: np.ndarray,
    mkpts_pred: np.ndarray,
    mkpts_gt_proj: np.ndarray,
    title: str = "",
    max_points: int = 200,
):
    """Predicted matches vs GT-pose projections with error whiskers
    (the reference's reprojection-pair TB figure)."""
    plt = _require_plt()
    fig, ax = plt.subplots(1, 1, figsize=(6, 6), dpi=100)
    ax.imshow(np.asarray(image).squeeze(), cmap="gray")
    n = min(len(mkpts_pred), max_points)
    for i in range(n):
        ax.plot(
            [mkpts_pred[i, 0], mkpts_gt_proj[i, 0]],
            [mkpts_pred[i, 1], mkpts_gt_proj[i, 1]],
            "-", color="yellow", linewidth=0.5,
        )
    if n:
        ax.scatter(mkpts_pred[:n, 0], mkpts_pred[:n, 1], s=4, c="lime", label="pred")
        ax.scatter(
            mkpts_gt_proj[:n, 0], mkpts_gt_proj[:n, 1], s=4, c="red", label="GT proj"
        )
        ax.legend(loc="upper right", fontsize=7)
    err = (
        float(np.mean(np.linalg.norm(mkpts_pred[:n] - mkpts_gt_proj[:n], axis=1)))
        if n
        else float("nan")
    )
    ax.set_title(f"{title} mean reproj err {err:.2f}px")
    ax.axis("off")
    fig.tight_layout()
    return fig


def plot_image_pair_matches(
    image0: np.ndarray,
    image1: np.ndarray,
    mkpts0: np.ndarray,
    mkpts1: np.ndarray,
    mconf: Optional[np.ndarray] = None,
    max_lines: int = 150,
):
    """Side-by-side image-pair match visualization (LoFTR-style)."""
    plt = _require_plt()
    h0, w0 = np.asarray(image0).squeeze().shape[:2]
    h1, w1 = np.asarray(image1).squeeze().shape[:2]
    fig, axes = plt.subplots(1, 2, figsize=(10, 5), dpi=100)
    axes[0].imshow(np.asarray(image0).squeeze(), cmap="gray")
    axes[1].imshow(np.asarray(image1).squeeze(), cmap="gray")
    for ax in axes:
        ax.axis("off")
    fig.canvas.draw()
    n = min(len(mkpts0), max_lines)
    cmap = plt.get_cmap("viridis")
    for i in range(n):
        c = cmap(float(mconf[i])) if mconf is not None else "lime"
        con = __import__("matplotlib.patches", fromlist=["ConnectionPatch"])
        patch = con.ConnectionPatch(
            xyA=(mkpts0[i, 0], mkpts0[i, 1]),
            coordsA=axes[0].transData,
            xyB=(mkpts1[i, 0], mkpts1[i, 1]),
            coordsB=axes[1].transData,
            color=c,
            linewidth=0.5,
        )
        fig.add_artist(patch)
    axes[0].scatter(mkpts0[:n, 0], mkpts0[:n, 1], s=3, c="lime")
    axes[1].scatter(mkpts1[:n, 0], mkpts1[:n, 1], s=3, c="lime")
    fig.tight_layout()
    return fig


def figure_to_array(fig) -> np.ndarray:
    """Rasterize a Figure to [H, W, 3] uint8 (for cv2 / TB image logging)."""
    fig.canvas.draw()
    buf = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
    w, h = fig.canvas.get_width_height()
    return buf.reshape(h, w, 4)[..., :3].copy()
