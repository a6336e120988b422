"""Covisible image-pair generation for SfM (host-side, numpy).

Behavioral port of the reference's three strategies
(``src/sfm_utils/pairs_exhaustive_all.py:4-12``, ``pairs_from_index.py:9-31``,
``pairs_from_poses.py:6-69``): exhaustive all-pairs, sliding index window, and
pose-covisibility top-k by camera-center distance with a minimum relative
rotation filter. Pair lists are tiny; numpy is the right tool.

The port's own copy of ``onepose_plus_plus_tpu/sfm/pairs.py`` (numpy).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

Pair = Tuple[int, int]


def exhaustive_pairs(n_images: int) -> List[Pair]:
    """All (i, j) with i < j."""
    return [(i, j) for i in range(n_images) for j in range(i + 1, n_images)]


def index_window_pairs(n_images: int, gap: int = 3) -> List[Pair]:
    """Sliding-window pairs by frame index: (i, i+gap) chains.

    Reference ``covis_from_index``: each frame pairs with the next ``gap``
    frames.
    """
    out = []
    for i in range(n_images):
        for d in range(1, gap + 1):
            if i + d < n_images:
                out.append((i, i + d))
    return out


def pose_covisibility_pairs(
    poses_w2c: Sequence[np.ndarray],
    num_matched: int = 10,
    min_rotation_deg: float = 10.0,
) -> List[Pair]:
    """Top-k nearest camera centers per frame, filtered by relative rotation.

    Reference ``covis_from_pose`` (``pairs_from_poses.py:6-69``): for each
    image take the ``num_matched`` closest other camera centers whose relative
    rotation exceeds ``min_rotation_deg`` (avoids near-duplicate frames that
    triangulate poorly).

    Args:
        poses_w2c: sequence of [4, 4] world->cam poses.
    Returns:
        deduplicated (i, j) pairs with i < j.
    """
    n = len(poses_w2c)
    Rs = np.stack([p[:3, :3] for p in poses_w2c])  # [n, 3, 3]
    ts = np.stack([p[:3, 3] for p in poses_w2c])
    centers = -np.einsum("nji,nj->ni", Rs, ts)  # -R^T t

    d2 = np.sum(
        (centers[:, None, :] - centers[None, :, :]) ** 2, axis=-1
    )  # [n, n]
    # relative rotation angle matrix
    Rrel_trace = np.einsum("nij,mij->nm", Rs, Rs)  # trace(R_n R_m^T)
    cos = np.clip((Rrel_trace - 1.0) / 2.0, -1.0, 1.0)
    ang = np.rad2deg(np.arccos(cos))

    eligible = ang >= min_rotation_deg
    np.fill_diagonal(eligible, False)
    d2_masked = np.where(eligible, d2, np.inf)

    pairs = set()
    k = min(num_matched, n - 1)
    order = np.argsort(d2_masked, axis=1)[:, :k]
    for i in range(n):
        for j in order[i]:
            if not np.isfinite(d2_masked[i, j]):
                continue
            pairs.add((min(i, int(j)), max(i, int(j))))
    return sorted(pairs)


def pairs_to_names(
    pairs: Sequence[Pair], names: Sequence[str]
) -> List[Tuple[str, str]]:
    return [(names[i], names[j]) for i, j in pairs]
