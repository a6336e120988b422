"""Point-cloud postprocessing: box filtering, track-length budgeting, merging.

Behavioral port of reference ``src/sfm_utils/postprocess/filter_points.py``
(:10-297) and ``filter_tkl.py`` (:11-89):

  * :func:`filter_by_3d_box` — keep points inside an oriented 3D box given by
    its 8 corners (half-space tests against the 3 box axes); the model
    variant detaches out-of-box tracks from images.
  * :func:`track_length_for_budget` — smallest min-track-length whose
    surviving point count fits the ``max_num_kp3d`` budget (``get_tkl``).
  * :func:`filter_track_length` — drop points with short tracks.
  * :func:`merge_close_points` — cluster points closer than a threshold and
    replace each cluster with its mean (union-find over the proximity graph,
    vectorized per chunk instead of a dense pdist).

The port's own copy of ``onepose_plus_plus_tpu/sfm/filtering.py`` (numpy).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..data.colmap_model import Image, Point3D


def box_axes_from_corners(corners: np.ndarray):
    """Oriented box -> (center [3], axes [3, 3] unit rows, half_sizes [3]).

    ``corners`` is [8, 3] with the reference ordering (Box.txt parse): corner 0
    adjacent to corners 1, 3, 4.
    """
    c0 = corners[0]
    edges = np.stack([corners[1] - c0, corners[3] - c0, corners[4] - c0])
    half = np.linalg.norm(edges, axis=1) / 2.0
    axes = edges / (2.0 * half[:, None])
    center = corners.mean(axis=0)
    return center, axes, half


def points_in_box(
    xyz: np.ndarray, corners: np.ndarray, padding_ratio: float = 0.0
) -> np.ndarray:
    """Bool mask of points inside the (optionally padded) oriented box."""
    center, axes, half = box_axes_from_corners(corners)
    local = (xyz - center) @ axes.T  # [N, 3]
    lim = half * (1.0 + padding_ratio)
    return np.all(np.abs(local) <= lim, axis=1)


def filter_by_3d_box(
    images: Dict[int, Image],
    points3d: Dict[int, Point3D],
    corners: np.ndarray,
    padding_ratio: float = 0.0,
) -> Dict[int, Point3D]:
    """Remove out-of-box points and detach their tracks from images (the
    reference ``filter_bbox`` model-rewrite variant)."""
    if not points3d:
        return points3d
    pids = np.fromiter(points3d.keys(), dtype=np.int64)
    xyz = np.stack([points3d[int(p)].xyz for p in pids])
    keep = points_in_box(xyz, corners, padding_ratio)
    removed = set(int(p) for p in pids[~keep])
    for im in images.values():
        bad = np.isin(im.point3D_ids, list(removed)) if removed else None
        if bad is not None and bad.any():
            im.point3D_ids[bad] = -1
    return {int(p): points3d[int(p)] for p in pids[keep]}


def track_length_for_budget(
    points3d: Dict[int, Point3D], max_num_kp3d: int = 15000
) -> int:
    """Smallest min-track-length keeping <= max_num_kp3d points (``get_tkl``)."""
    if not points3d:
        return 2
    lens = np.array([len(p.image_ids) for p in points3d.values()])
    for thr in range(2, int(lens.max()) + 2):
        if (lens >= thr).sum() <= max_num_kp3d:
            return thr
    return int(lens.max()) + 1


def filter_track_length(
    images: Dict[int, Image],
    points3d: Dict[int, Point3D],
    min_track_length: int,
) -> Dict[int, Point3D]:
    """Drop points whose track is shorter than the threshold."""
    removed = {
        pid for pid, p in points3d.items() if len(p.image_ids) < min_track_length
    }
    for im in images.values():
        if removed:
            bad = np.isin(im.point3D_ids, list(removed))
            im.point3D_ids[bad] = -1
    return {pid: p for pid, p in points3d.items() if pid not in removed}


def merge_close_points(
    images: Dict[int, Image],
    points3d: Dict[int, Point3D],
    dist_threshold: float = 1e-3,
    chunk: int = 2048,
) -> Dict[int, Point3D]:
    """Merge clusters of points closer than ``dist_threshold`` into their mean.

    Reference ``merge`` (``filter_points.py:265+``) clusters via scipy pdist;
    here a grid hash bins points at the threshold scale and only neighboring
    bins are compared, keeping memory linear for 15k-point clouds.
    """
    if not points3d:
        return points3d
    pids = sorted(points3d.keys())
    xyz = np.stack([points3d[p].xyz for p in pids])
    n = len(pids)
    parent = np.arange(n)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    # hash points to grid cells of size dist_threshold
    cell = np.floor(xyz / dist_threshold).astype(np.int64)
    buckets: Dict[tuple, list] = {}
    for i, c in enumerate(map(tuple, cell)):
        buckets.setdefault(c, []).append(i)
    offsets = [
        (dx, dy, dz)
        for dx in (-1, 0, 1)
        for dy in (-1, 0, 1)
        for dz in (-1, 0, 1)
    ]
    thr2 = dist_threshold**2
    for c, idxs in buckets.items():
        cand = []
        for off in offsets:
            cand.extend(buckets.get((c[0] + off[0], c[1] + off[1], c[2] + off[2]), []))
        cand = np.asarray(cand)
        for i in idxs:
            d2 = np.sum((xyz[cand] - xyz[i]) ** 2, axis=1)
            for j in cand[d2 <= thr2]:
                if i != j:
                    ri, rj = find(i), find(int(j))
                    if ri != rj:
                        parent[rj] = ri

    roots = np.array([find(i) for i in range(n)])
    out: Dict[int, Point3D] = {}
    remap: Dict[int, int] = {}  # old pid -> merged pid
    for r in np.unique(roots):
        members = np.flatnonzero(roots == r)
        main_pid = pids[members[0]]
        p_main = points3d[main_pid]
        if len(members) > 1:
            p_main.xyz = xyz[members].mean(axis=0)
            im_ids = [points3d[pids[m]].image_ids for m in members]
            kp_ids = [points3d[pids[m]].point2D_idxs for m in members]
            p_main.image_ids = np.concatenate(im_ids)
            p_main.point2D_idxs = np.concatenate(kp_ids)
            p_main.error = float(
                np.mean([points3d[pids[m]].error for m in members])
            )
        out[main_pid] = p_main
        for m in members:
            remap[pids[m]] = main_pid
    for im in images.values():
        reg = im.point3D_ids >= 0
        im.point3D_ids[reg] = np.array(
            [remap.get(int(p), -1) for p in im.point3D_ids[reg]], np.int64
        )
    return out
