"""Incremental SfM for unknown camera poses (port of
``onepose_plus_plus_tpu/sfm/incremental.py``; the COLMAP ``mapper`` of the
reference's demo-from-scratch path).

1. seed pair: the most-matched pair whose RANSAC essential-matrix relative
   pose (``geometry/bundle_adjust.py::estimate_relative_pose``) is confident;
2. two-view triangulation of the seed tracks;
3. grow: register the unregistered image with the most 2D-3D
   correspondences by RANSAC-PnP, triangulate the tracks it completes, and
   re-refine every camera's extrinsics every ``refine_every`` registrations;
4. a final extrinsics-only refinement and re-triangulation.

The loop is driven from the host (cameras are few); every solve inside is a
batched program on ``device``. RANSAC samples come from one
``torch.Generator`` seeded ``rng_seed`` on that device.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..geometry.bundle_adjust import estimate_relative_pose, refine_extrinsics
from ..geometry.pnp import ransac_pnp
from ..geometry.triangulation import triangulate_and_filter
from .coarse_match import SceneKeypoints
from .tracks import build_tracks, tracks_to_arrays

Pair = Tuple[int, int]


def _capacity(n: int) -> int:
    """Fixed padded size for n correspondences: a power of two, at least 64."""
    return max(64, 1 << int(np.ceil(np.log2(n))))


def _triangulate_tracks_subset(tracks, track_ids, keypoints, Ks, poses, max_track_length,
                               max_reproj_px, device):
    """Triangulate the given tracks from their registered observations only."""
    sub = []
    for ti in track_ids:
        obs = {im: k for im, k in tracks[ti].items() if im in poses}
        if len(obs) >= 2:
            sub.append((ti, obs))
    if not sub:
        return {}
    pack = tracks_to_arrays([obs for _, obs in sub], keypoints, Ks, poses, max_track_length)
    dev = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    xyz, _, ok, _ = triangulate_and_filter(dev(pack["K"]), dev(pack["T_w2c"]), dev(pack["uv"]),
                                           dev(pack["valid"]), max_reproj_px=max_reproj_px)
    ok, xyz = ok.cpu().numpy(), xyz.cpu().numpy()
    return {ti: xyz[row] for row, (ti, _) in enumerate(sub) if ok[row]}


def incremental_sfm(
    scene: SceneKeypoints,
    Ks: Dict[int, np.ndarray],
    min_seed_matches: int = 50,
    min_pnp_correspondences: int = 12,
    pnp_capacity: int = 2048,
    reproj_threshold_px: float = 4.0,
    max_track_length: int = 16,
    refine_every: int = 3,
    rng_seed: int = 0,
    device: str = "cuda",
) -> dict:
    """Map a scene with unknown poses from its pairwise matches.

    Returns a dict with ``poses`` {img_id: [4, 4] world->cam}, ``points``
    {track index: xyz}, ``tracks`` (the track list) and the ``registered``
    order. The scale is the monocular gauge (seed baseline 1).
    """
    gen = torch.Generator(device=device)
    gen.manual_seed(rng_seed)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    counts = {i: len(k) for i, k in scene.keypoints.items()}
    tracks = build_tracks(counts, scene.match_indices, scene.match_confs)
    obs_to_track: Dict[Tuple[int, int], int] = {}
    for ti, obs in enumerate(tracks):
        for im, k in obs.items():
            obs_to_track[(im, k)] = ti

    def triangulate(track_ids):
        return _triangulate_tracks_subset(tracks, track_ids, scene.keypoints, Ks, poses,
                                          max_track_length, reproj_threshold_px, device)

    # 1. seed pair
    poses: Dict[int, np.ndarray] = {}
    registered: List[int] = []
    for pair in sorted(scene.match_indices, key=lambda p: -len(scene.match_indices[p])):
        m = scene.match_indices[pair]
        if len(m) < min_seed_matches:
            continue
        i, j = pair
        cap = _capacity(len(m))
        p0 = np.zeros((cap, 2), np.float32)
        p1 = np.zeros((cap, 2), np.float32)
        vmask = np.zeros(cap, bool)
        p0[: len(m)] = scene.keypoints[i][m[:, 0]]
        p1[: len(m)] = scene.keypoints[j][m[:, 1]]
        vmask[: len(m)] = True
        rel = estimate_relative_pose(dev(p0), dev(p1), dev(Ks[i].astype(np.float32)),
                                     dev(Ks[j].astype(np.float32)), dev(vmask), gen,
                                     threshold_px=reproj_threshold_px)
        if not bool(rel.ok) or int(rel.num_inliers) < min_seed_matches // 2:
            continue
        T1 = np.eye(4)
        T1[:3, :3] = rel.R.cpu().numpy()
        T1[:3, 3] = rel.t.cpu().numpy()
        poses[i], poses[j] = np.eye(4), T1
        registered = [i, j]
        break
    if not registered:
        return {"poses": {}, "points": {}, "tracks": tracks, "registered": []}

    # 2. seed triangulation
    points: Dict[int, np.ndarray] = dict(triangulate(range(len(tracks))))

    # 3. grow
    all_imgs = sorted(scene.keypoints)
    since_refine = 0
    while True:
        best_img, best_corr = None, []
        for im in all_imgs:
            if im in poses:
                continue
            corr = [(k, obs_to_track[(im, k)]) for k in range(counts[im])
                    if obs_to_track.get((im, k)) in points]
            if len(corr) > len(best_corr):
                best_img, best_corr = im, corr
        if best_img is None or len(best_corr) < min_pnp_correspondences:
            break
        corr = best_corr[:pnp_capacity]
        cap = _capacity(len(corr))
        p3 = np.zeros((1, cap, 3), np.float32)
        p2 = np.zeros((1, cap, 2), np.float32)
        vmask = np.zeros((1, cap), bool)
        for s, (k, ti) in enumerate(corr):
            p3[0, s] = points[ti]
            p2[0, s] = scene.keypoints[best_img][k]
            vmask[0, s] = True
        res = ransac_pnp(dev(p3), dev(p2), dev(Ks[best_img].astype(np.float32)[None]), dev(vmask), gen,
                         reproj_threshold_px=reproj_threshold_px)
        if not bool(res.ok[0]):
            all_imgs.remove(best_img)  # unregistrable: stop retrying it
            continue
        T = np.eye(4)
        T[:3, :3] = res.R[0].cpu().numpy()
        T[:3, 3] = res.t[0].cpu().numpy()
        poses[best_img] = T
        registered.append(best_img)
        since_refine += 1
        # triangulate the tracks this image completes
        fresh = [obs_to_track[(best_img, k)] for k in range(counts[best_img])
                 if (best_img, k) in obs_to_track and obs_to_track[(best_img, k)] not in points]
        points.update(triangulate(fresh))
        if since_refine >= refine_every:
            since_refine = 0
            _refine_all(poses, points, tracks, scene, Ks, pnp_capacity, device)

    # 4. final refinement, then every track again with the final poses
    _refine_all(poses, points, tracks, scene, Ks, pnp_capacity, device)
    points = triangulate(range(len(tracks)))
    return {"poses": poses, "points": points, "tracks": tracks, "registered": registered}


def _refine_all(poses, points, tracks, scene, Ks, capacity, device):
    """Extrinsics-only refinement of every registered camera (points fixed),
    in place on ``poses``."""
    imgs = sorted(poses)
    if not imgs:
        return
    c, m = len(imgs), capacity
    p3 = np.zeros((c, m, 3), np.float32)
    uv = np.zeros((c, m, 2), np.float32)
    Karr = np.zeros((c, 3, 3), np.float32)
    valid = np.zeros((c, m), bool)
    Tarr = np.zeros((c, 4, 4), np.float32)
    for ci, im in enumerate(imgs):
        Karr[ci] = Ks[im]
        Tarr[ci] = poses[im]
        s = 0
        for ti, obs in enumerate(tracks):
            if s >= m:
                break
            if ti in points and im in obs:
                p3[ci, s] = points[ti]
                uv[ci, s] = scene.keypoints[im][obs[im]]
                valid[ci, s] = True
                s += 1
    dev = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    T_ref, _ = refine_extrinsics(dev(Tarr), dev(Karr), dev(p3), dev(uv), dev(valid))
    T_ref = T_ref.cpu().numpy()
    for ci, im in enumerate(imgs):
        poses[im] = T_ref[ci]
