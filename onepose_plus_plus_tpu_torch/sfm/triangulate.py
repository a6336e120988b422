"""Known-pose scene triangulation driver: the COLMAP-replacement pipeline.

End-to-end equivalent of reference ``src/sfm_utils/generate_empty.py`` (model
with known poses) + ``triangulation.py`` (sqlite import, C++
``matches_importer`` geometric verification, C++ ``point_triangulator``):

  1. per-pair epipolar verification of index matches on device
     (:func:`~onepose_plus_plus_tpu_torch.geometry.epipolar.verify_matches`);
  2. union-find track building on host (:mod:`.tracks`);
  3. robust batched DLT triangulation + filtering on device
     (:func:`~onepose_plus_plus_tpu_torch.geometry.triangulation.triangulate_and_filter`);
  4. assembly of a COLMAP model (cameras/images/points3D) for downstream
     interop (:mod:`..data.colmap_model`).

No sqlite database, no subprocesses: the correspondence data flows through
numpy arrays and torch tensors on ``device``, and the only persisted artifact
is the final model. Port of ``onepose_plus_plus_tpu/sfm/triangulate.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..data.colmap_model import Camera, Image, Point3D, model_stats
from ..geometry.epipolar import verify_matches
from ..geometry.rotations import matrix_to_qvec
from ..geometry.triangulation import triangulate_and_filter
from .coarse_match import SceneKeypoints
from .tracks import build_tracks, tracks_to_arrays

Pair = Tuple[int, int]


@dataclasses.dataclass
class TriangulationResult:
    cameras: Dict[int, Camera]
    images: Dict[int, Image]
    points3d: Dict[int, Point3D]
    stats: dict


def verify_scene_matches(
    scene: SceneKeypoints,
    Ks: Dict[int, np.ndarray],
    Ts: Dict[int, np.ndarray],
    max_error_px: float = 4.0,
    chunk: int = 4096,
    device: str = "cuda",
) -> Dict[Pair, np.ndarray]:
    """Epipolar-verify every pair's index matches in one padded device batch.

    All pairs' matches are flattened into a single [B, N] problem (N = max
    matches over pairs, padded) so verification is one kernel launch per
    ``chunk`` of pairs rather than one COLMAP subprocess per scene.

    Returns pair -> bool mask over that pair's matches.
    """
    pairs = list(scene.match_indices)
    if not pairs:
        return {}
    n_cap = max(len(scene.match_indices[p]) for p in pairs)
    n_cap = max(n_cap, 1)
    out: Dict[Pair, np.ndarray] = {}
    for s in range(0, len(pairs), chunk):
        batch = pairs[s : s + chunk]
        b = len(batch)
        K0 = np.zeros((b, 3, 3), np.float32)
        K1 = np.zeros((b, 3, 3), np.float32)
        T0 = np.zeros((b, 4, 4), np.float32)
        T1 = np.zeros((b, 4, 4), np.float32)
        p0 = np.zeros((b, n_cap, 2), np.float32)
        p1 = np.zeros((b, n_cap, 2), np.float32)
        valid = np.zeros((b, n_cap), bool)
        for bi, (i, j) in enumerate(batch):
            m = scene.match_indices[(i, j)]
            K0[bi], K1[bi] = Ks[i], Ks[j]
            T0[bi], T1[bi] = Ts[i], Ts[j]
            p0[bi, : len(m)] = scene.keypoints[i][m[:, 0]]
            p1[bi, : len(m)] = scene.keypoints[j][m[:, 1]]
            valid[bi, : len(m)] = True
        dev = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        inl = verify_matches(
            dev(K0), dev(K1), dev(T0), dev(T1), dev(p0), dev(p1), dev(valid),
            max_error_px=max_error_px,
        ).cpu().numpy()
        for bi, (i, j) in enumerate(batch):
            m = scene.match_indices[(i, j)]
            out[(i, j)] = inl[bi, : len(m)]
    return out


def triangulate_scene(
    scene: SceneKeypoints,
    Ks: Dict[int, np.ndarray],
    Ts: Dict[int, np.ndarray],
    image_sizes: Dict[int, Tuple[int, int]],
    image_names: Dict[int, str] = None,
    max_error_px: float = 4.0,
    max_reproj_px: float = 4.0,
    min_tri_angle_deg: float = 1.5,
    min_track_length: int = 2,
    max_track_length: int = 32,
    track_device_batch: int = 16384,
    device: str = "cuda",
) -> TriangulationResult:
    """Full known-pose triangulation: verification -> tracks -> points3D.

    Args:
        scene: merged keypoints + index matches from coarse matching.
        Ks: img_id -> [3, 3]; Ts: img_id -> [4, 4] world->cam (known poses).
        image_sizes: img_id -> (height, width).
        image_names: img_id -> filename (defaults to ``{id:06d}.png``).
    Returns:
        TriangulationResult with a COLMAP-layout model + analyzer stats.
    """
    # 1. geometric verification (device)
    inlier_masks = verify_scene_matches(scene, Ks, Ts, max_error_px, device=device)
    verified = {
        p: scene.match_indices[p][mask]
        for p, mask in inlier_masks.items()
        if mask.any()
    }
    verified_conf = {
        p: scene.match_confs[p][inlier_masks[p]] for p in verified
    }

    # 2. track building (host union-find)
    counts = {i: len(k) for i, k in scene.keypoints.items()}
    tracks = build_tracks(counts, verified, verified_conf, min_track_length)

    # 3. batched triangulation (device), chunked over track capacity
    img_ids_sorted = sorted(scene.keypoints)
    xyz_list, inl_list, ok_list, err_list = [], [], [], []
    packs = []
    for s in range(0, len(tracks), track_device_batch):
        pack = tracks_to_arrays(
            tracks[s : s + track_device_batch],
            scene.keypoints,
            Ks,
            Ts,
            max_track_length,
        )
        packs.append(pack)
        dev = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        xyz, obs_inl, ok, err = triangulate_and_filter(
            dev(pack["K"]),
            dev(pack["T_w2c"]),
            dev(pack["uv"]),
            dev(pack["valid"]),
            max_reproj_px=max_reproj_px,
            min_tri_angle_deg=min_tri_angle_deg,
        )
        xyz_list.append(xyz.cpu().numpy())
        inl_list.append(obs_inl.cpu().numpy())
        ok_list.append(ok.cpu().numpy())
        err_list.append(err.cpu().numpy())

    # 4. assemble COLMAP model
    cameras: Dict[int, Camera] = {}
    images: Dict[int, Image] = {}
    for i in img_ids_sorted:
        K = np.asarray(Ks[i])
        h, w = image_sizes[i]
        cameras[i] = Camera(
            i,
            "PINHOLE",
            int(w),
            int(h),
            np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], np.float64),
        )
        T = np.asarray(Ts[i])
        qvec = matrix_to_qvec(torch.from_numpy(np.asarray(T[:3, :3], np.float32))).numpy()
        kpts = scene.keypoints[i]
        images[i] = Image(
            i,
            qvec.astype(np.float64),
            T[:3, 3].astype(np.float64),
            i,
            image_names[i] if image_names else f"{i:06d}.png",
            kpts.astype(np.float64),
            np.full(len(kpts), -1, np.int64),
        )

    points3d: Dict[int, Point3D] = {}
    pid = 1
    for pack, xyz, obs_inl, ok, err in zip(
        packs, xyz_list, inl_list, ok_list, err_list
    ):
        for ti in np.flatnonzero(ok):
            sel = obs_inl[ti]
            im_ids = pack["img_ids"][ti][sel]
            kp_ids = pack["kpt_idx"][ti][sel]
            points3d[pid] = Point3D(
                pid,
                xyz[ti].astype(np.float64),
                np.zeros(3, np.uint8),
                float(np.mean(err[ti][sel])),
                im_ids.astype(np.int64),
                kp_ids.astype(np.int64),
            )
            for im, k in zip(im_ids, kp_ids):
                images[int(im)].point3D_ids[int(k)] = pid
            pid += 1

    return TriangulationResult(
        cameras, images, points3d, model_stats(cameras, images, points3d)
    )
