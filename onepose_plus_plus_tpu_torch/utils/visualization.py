"""Visualization: 3D-box reprojection drawing, demo frames, video writing.

The port's own copy of ``onepose_plus_plus_tpu/utils/visualization.py``
(numpy and the optional OpenCV, with a line-drawing fallback without it).
Behavioral port of reference ``src/utils/vis_utils.py`` (3D box rendering on
demo frames + mp4 assembly via cv2 VideoWriter) and the PLY dump used by
``filter_tkl.vis_tkl_filtered_pcds``.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

try:
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False

# box edges for the standard 8-corner ordering (z-varying pairs)
BOX_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def project_box_corners(
    corners_3d: np.ndarray, pose_w2c: np.ndarray, K: np.ndarray
) -> np.ndarray:
    """[8, 3] world box corners -> [8, 2] pixel coords."""
    pc = corners_3d @ pose_w2c[:3, :3].T + pose_w2c[:3, 3]
    uvw = pc @ K.T
    return uvw[:, :2] / np.clip(uvw[:, 2:3], 1e-9, None)


def draw_3d_box(
    image: np.ndarray,
    corners_2d: np.ndarray,
    color=(0, 255, 0),
    thickness: int = 2,
) -> np.ndarray:
    """Draw the projected 3D box wireframe on an image (uint8 BGR or gray)."""
    img = image.copy()
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    # clamp to an int32-safe range: garbage poses (e.g. before tracking locks
    # on) can project corners to +-1e12, which overflows cv2's point parsing
    lim = 10 * max(img.shape[0], img.shape[1])
    corners_2d = np.nan_to_num(corners_2d, nan=0.0, posinf=lim, neginf=-lim)
    pts = np.round(np.clip(corners_2d, -lim, lim)).astype(np.int32)
    for a, b in BOX_EDGES:
        if _HAS_CV2:
            cv2.line(img, tuple(pts[a]), tuple(pts[b]), color, thickness)
        else:  # pragma: no cover — crude fallback
            for t in np.linspace(0, 1, 64):
                x, y = np.round(pts[a] * (1 - t) + pts[b] * t).astype(int)
                if 0 <= y < img.shape[0] and 0 <= x < img.shape[1]:
                    img[y, x] = color
    return img


def save_demo_frame(
    image: np.ndarray,
    pose_w2c: np.ndarray,
    K: np.ndarray,
    box_corners_3d: np.ndarray,
    out_path: str,
    inliers: Optional[int] = None,
) -> np.ndarray:
    """Render the pose as a 3D box overlay and save (reference save_demo_image)."""
    corners_2d = project_box_corners(box_corners_3d, pose_w2c, K)
    img = draw_3d_box(image, corners_2d)
    if inliers is not None and _HAS_CV2:
        cv2.putText(
            img,
            f"inliers: {inliers}",
            (8, 24),
            cv2.FONT_HERSHEY_SIMPLEX,
            0.7,
            (0, 255, 255),
            2,
        )
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    if _HAS_CV2:
        cv2.imwrite(out_path, img)
    return img


def make_video(
    frame_paths: Sequence[str], out_path: str, fps: int = 24
) -> None:
    """Assemble saved frames into an mp4 (reference make_video)."""
    if not _HAS_CV2 or not frame_paths:  # pragma: no cover
        return
    first = cv2.imread(frame_paths[0])
    h, w = first.shape[:2]
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    writer = cv2.VideoWriter(
        out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
    )
    for p in frame_paths:
        img = cv2.imread(p)
        if img is not None:
            writer.write(img)
    writer.release()


def save_ply(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None):
    """Minimal ASCII PLY dump (reference model_converter PLY export parity)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write(
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            )
        f.write("end_header\n")
        for i in range(n):
            row = f"{points[i, 0]} {points[i, 1]} {points[i, 2]}"
            if colors is not None:
                c = colors[i].astype(int)
                row += f" {c[0]} {c[1]} {c[2]}"
            f.write(row + "\n")
