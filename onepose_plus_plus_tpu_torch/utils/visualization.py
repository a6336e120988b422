"""PLY point-cloud dump (the port's own copy of ``save_ply`` from
``onepose_plus_plus_tpu/utils/visualization.py``; the SfM runner's
pre/post-filter clouds). The demo's drawing and video helpers belong to a
later slice."""
from __future__ import annotations

import os
from typing import Optional

import numpy as np


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
