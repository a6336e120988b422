"""SfM post-optimization: keyframe assignment, fine match refinement, and
batched depth optimization (the reference's DeepLM stage). Port of
``onepose_plus_plus_tpu/sfm/post_optimization.py``: the host code is the
same, the depth solve runs on ``device``.

Behavioral port of reference ``src/KeypointFreeSfM/post_optimization/`` +
``dataset/coarse_colmap_dataset.py``:

  * :func:`assign_keyframes_greedy` — the greedy feature-track assignment
    (``coarse_colmap_dataset.py:220-310``): repeatedly promote the image with
    the most unoccupied registered keypoints to keyframe; every 3D point is
    assigned to exactly one (keyframe, kpt) observation, the rest of its track
    is marked robbed. State codes: -3 robbed, -2 unoccupied, -1 unregistered,
    >=0 assigned 3D id. Inherently sequential, stays on host (SURVEY.md §7.3).
  * :func:`build_refinement_pairs` — (keyframe, related-frame) pairs with
    their shared-track coarse correspondences (``construct_matching_data.py``).
  * :func:`run_fine_refinement` — batches those pairs through the LoFTR
    ``refine`` mode (replaces 4x fractional-GPU Ray workers,
    ``fine_match_worker.py``) with fixed match capacity.
  * :func:`optimize_depths` — one batched scalar-LM solve over ALL tracks at
    once (replaces the C++/CUDA DeepLM ``Solve``; poses constant, exactly the
    reference's production ``optim_procedure=["depth"]``).
  * :func:`write_back` — refined depths -> world points; all registered 2D
    keypoints reprojected from refined points
    (``update_optimize_results_to_colmap``, ``coarse_colmap_dataset.py:312+``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..data.colmap_model import Camera, Image, Point3D
from ..geometry.levenberg_marquardt import first_order_solve, lm_solve_scalar
from ..geometry.residuals import depth_residual_track
from ..geometry.rotations import matrix_to_angle_axis
from ..utils.profiling import annotate

Pair = Tuple[int, int]


# ----------------------- keyframe / track assignment ------------------------


def assign_keyframes_greedy(
    images: Dict[int, Image], points3d: Dict[int, Point3D]
):
    """Greedy keyframe selection + unique track assignment.

    Returns:
        keyframe_states: {img_id: state [N] int64} for selected keyframes;
        assignment: {point3d_id: (img_id, kpt_idx)}.
    """
    states = {}
    unoccupied = {}
    for iid, im in images.items():
        st = np.full(len(im.xys), -2, np.int64)
        st[im.point3D_ids < 0] = -1
        states[iid] = st
        unoccupied[iid] = int((st == -2).sum())

    remaining = set(points3d.keys())
    keyframes: Dict[int, np.ndarray] = {}
    assignment: Dict[int, Tuple[int, int]] = {}
    active = dict(unoccupied)

    while remaining:
        if not active:
            break
        kf = max(active, key=lambda k: active[k])
        if active[kf] == 0:
            break
        del active[kf]
        st = states[kf]
        im = images[kf]
        occ_mask = st == -2
        st[occ_mask] = im.point3D_ids[occ_mask]
        keyframes[kf] = st
        for kpt_idx in np.flatnonzero(occ_mask):
            pid = int(im.point3D_ids[kpt_idx])
            if pid not in remaining:
                # 3D point already assigned (duplicate obs in this image)
                st[kpt_idx] = -3
                continue
            assignment[pid] = (kf, int(kpt_idx))
            remaining.discard(pid)
            p = points3d[pid]
            for other_im, other_kpt in zip(p.image_ids, p.point2D_idxs):
                other_im = int(other_im)
                if other_im == kf:
                    continue
                ost = states[other_im]
                if ost[other_kpt] == -2:
                    ost[other_kpt] = -3
                    if other_im in active:
                        active[other_im] -= 1
    return keyframes, assignment


def related_frames(
    keyframe_states: Dict[int, np.ndarray],
    points3d: Dict[int, Point3D],
) -> Dict[int, List[int]]:
    """For each keyframe: the set of frames sharing a track with it
    (reference ``extract_corresponding_frames``)."""
    out: Dict[int, List[int]] = {}
    for kf, st in keyframe_states.items():
        rel = set()
        for pid in st[st >= 0]:
            for im in points3d[int(pid)].image_ids:
                rel.add(int(im))
        rel.discard(kf)
        out[kf] = sorted(rel)
    return out


# ------------------------- refinement pair building -------------------------


@dataclasses.dataclass
class RefinementPair:
    pair: Pair  # (keyframe_id, related_frame_id)
    mkpts0: np.ndarray  # [M, 2] keyframe keypoints (track-assigned)
    mkpts1: np.ndarray  # [M, 2] related-frame observations of the same tracks
    point3d_ids: np.ndarray  # [M] track ids


def build_refinement_pairs(
    images: Dict[int, Image],
    points3d: Dict[int, Point3D],
    keyframe_states: Dict[int, np.ndarray],
) -> List[RefinementPair]:
    """Coarse correspondences per (keyframe, related frame) from shared tracks."""
    rel = related_frames(keyframe_states, points3d)
    out = []
    for kf, frames in rel.items():
        st = keyframe_states[kf]
        kf_xys = images[kf].xys
        # track id -> keyframe kpt idx (assigned observations only)
        tracks = {int(st[k]): k for k in np.flatnonzero(st >= 0)}
        # index related-frame observations per track
        for fr in frames:
            m0, m1, pids = [], [], []
            fr_im = images[fr]
            for pid, kf_kpt in tracks.items():
                p = points3d[pid]
                hit = np.flatnonzero(p.image_ids == fr)
                if len(hit) == 0:
                    continue
                p2 = int(p.point2D_idxs[hit[0]])
                m0.append(kf_xys[kf_kpt])
                m1.append(fr_im.xys[p2])
                pids.append(pid)
            if m0:
                out.append(
                    RefinementPair(
                        (kf, fr),
                        np.stack(m0).astype(np.float32),
                        np.stack(m1).astype(np.float32),
                        np.asarray(pids, np.int64),
                    )
                )
    return out


def run_fine_refinement(
    refine_fn: Callable,
    images_px: Dict[int, np.ndarray],
    pairs: Sequence[RefinementPair],
    match_capacity: int = 1024,
    pair_batch: int = 8,
) -> Dict[Pair, dict]:
    """Batch refinement pairs through the LoFTR ``refine`` mode.

    Args:
        refine_fn: batched (img0 [B,H,W,1], img1, mkpts0 [B,K,2], mkpts1,
            mask [B,K]) -> dict with ``mkpts1_f`` [B,K,2] (and optional
            ``feat_*`` outputs).
        images_px: img_id -> [H, W] grayscale in network resolution, of one
            shape over the pairs' images (the refine surface takes no
            padding masks; ``run_pairs`` pads mixed shapes, this raises).
        match_capacity: static per-pair match slots (longest pair must fit).
    Returns:
        pair -> {"mkpts0", "mkpts1_f", "point3d_ids"} with padding stripped.
    """
    out: Dict[Pair, dict] = {}
    pairs = list(pairs)
    shapes = {images_px[i].shape for p in pairs for i in p.pair}
    if len(shapes) > 1:
        raise ValueError(
            "run_fine_refinement requires uniform image shapes for device batching, got "
            f"{sorted(shapes)}; resize via load_gray_resize_divisible(resize_max=...)"
        )
    with annotate("run_fine_refinement", pairs=len(pairs)):
        for s in range(0, len(pairs), pair_batch):
            chunk = pairs[s : s + pair_batch]
            pad = pair_batch - len(chunk)
            chunk_p = chunk + [chunk[-1]] * pad
            b = len(chunk_p)
            with annotate("sfm.stack"):
                img0 = np.stack([images_px[p.pair[0]][..., None] for p in chunk_p])
                img1 = np.stack([images_px[p.pair[1]][..., None] for p in chunk_p])
                mk0 = np.zeros((b, match_capacity, 2), np.float32)
                mk1 = np.zeros((b, match_capacity, 2), np.float32)
                mask = np.zeros((b, match_capacity), bool)
                for bi, p in enumerate(chunk_p):
                    m = min(len(p.mkpts0), match_capacity)
                    mk0[bi, :m] = p.mkpts0[:m]
                    mk1[bi, :m] = p.mkpts1[:m]
                    mask[bi, :m] = True
            res = refine_fn(img0, img1, mk0, mk1, mask)
            with annotate("sfm.unpack"):
                mk1f = np.asarray(res["mkpts1_f"])
                for bi, p in enumerate(chunk):
                    m = min(len(p.mkpts0), match_capacity)
                    out[p.pair] = {
                        "mkpts0": p.mkpts0[:m],
                        "mkpts1_f": mk1f[bi, :m],
                        "point3d_ids": p.point3d_ids[:m],
                    }
    return out


# --------------------------- depth optimization -----------------------------


def build_depth_problems(
    cameras: Dict[int, Camera],
    images: Dict[int, Image],
    points3d: Dict[int, Point3D],
    assignment: Dict[int, Tuple[int, int]],
    fine_matches: Dict[Pair, dict],
    max_track_length: int = 16,
) -> dict:
    """Pack per-track depth-refinement problems into fixed-capacity arrays.

    Equivalent of ``ConstructOptimizationData`` (reference
    ``construct_optimization_data.py``): for every assigned 3D point, gather
    the fine-refined observations of its track across related frames plus the
    keyframe intrinsics/pose and initial depth (z of the current point in the
    keyframe camera).
    """
    # index fine matches: (kf, pid) -> list of (frame, uv1)
    obs: Dict[int, List[Tuple[int, np.ndarray]]] = {}
    for (kf, fr), d in fine_matches.items():
        for pid, uv1 in zip(d["point3d_ids"], d["mkpts1_f"]):
            obs.setdefault(int(pid), []).append((fr, uv1))

    pids = [pid for pid in assignment if pid in obs and len(obs[pid]) > 0]
    n = len(pids)
    v = max_track_length
    uv0 = np.zeros((n, 2), np.float32)
    uv1 = np.zeros((n, v, 2), np.float32)
    K0 = np.zeros((n, 3, 3), np.float32)
    K1 = np.tile(np.eye(3, dtype=np.float32), (n, v, 1, 1))
    p0aa = np.zeros((n, 3), np.float32)
    p0t = np.zeros((n, 3), np.float32)
    p1aa = np.zeros((n, v, 3), np.float32)
    p1t = np.zeros((n, v, 3), np.float32)
    valid = np.zeros((n, v), bool)
    depth0 = np.zeros(n, np.float32)

    aa_cache: Dict[int, np.ndarray] = {}

    def frame_aa_t(iid):
        if iid not in aa_cache:
            R = images[iid].R()
            aa_cache[iid] = (
                matrix_to_angle_axis(torch.from_numpy(np.asarray(R, np.float32))).numpy(),
                images[iid].tvec.astype(np.float32),
            )
        return aa_cache[iid]

    for ti, pid in enumerate(pids):
        kf, kpt = assignment[pid]
        im = images[kf]
        uv0[ti] = im.xys[kpt]
        K0[ti] = cameras[im.camera_id].K
        aa, t = frame_aa_t(kf)
        p0aa[ti], p0t[ti] = aa, t
        # initial depth: z of the triangulated point in the keyframe camera
        pc = im.R() @ points3d[pid].xyz + im.tvec
        depth0[ti] = max(pc[2], 1e-3)
        for s, (fr, uv) in enumerate(obs[pid][:v]):
            uv1[ti, s] = uv
            K1[ti, s] = cameras[images[fr].camera_id].K
            aa, t = frame_aa_t(fr)
            p1aa[ti, s], p1t[ti, s] = aa, t
            valid[ti, s] = True

    return {
        "point3d_ids": np.asarray(pids, np.int64),
        "uv0": uv0,
        "uv1": uv1,
        "K0": K0,
        "K1": K1,
        "pose0_aa": p0aa,
        "pose0_t": p0t,
        "pose1_aa": p1aa,
        "pose1_t": p1t,
        "valid": valid,
        "depth0": depth0,
    }


def optimize_depths(
    problems: dict,
    solver: str = "lm",
    max_iters: int = 20,
    first_order_lr: float = 3e-2,
    first_order_iters: int = 1000,
    device: str = "cuda",
) -> np.ndarray:
    """Solve every track's scalar depth in one batched pass on ``device``.

    ``solver='lm'`` is the DeepLM-equivalent second-order path;
    ``'first_order'`` mirrors the reference Adam fallback.
    """
    args = tuple(
        torch.from_numpy(problems[k]).to(device)
        for k in (
            "uv0",
            "uv1",
            "K0",
            "K1",
            "pose0_aa",
            "pose0_t",
            "pose1_aa",
            "pose1_t",
            "valid",
        )
    )
    d0 = torch.from_numpy(problems["depth0"]).to(device)
    if solver == "lm":
        d, _ = lm_solve_scalar(
            depth_residual_track, d0, args, max_iters=max_iters
        )
    elif solver == "first_order":
        d, _ = first_order_solve(
            depth_residual_track,
            d0,
            args,
            lr=first_order_lr,
            max_iters=first_order_iters,
        )
    else:
        raise ValueError(f"unknown solver {solver}")
    out = d.cpu().numpy()
    # reject non-finite / non-positive refinements, keep the initialization
    bad = ~np.isfinite(out) | (out <= 0)
    out[bad] = problems["depth0"][bad]
    return out


# -------------------------------- write-back --------------------------------


def write_back(
    cameras: Dict[int, Camera],
    images: Dict[int, Image],
    points3d: Dict[int, Point3D],
    assignment: Dict[int, Tuple[int, int]],
    point3d_ids: np.ndarray,
    depths: np.ndarray,
) -> None:
    """Apply refined depths in place: move 3D points, reproject 2D keypoints."""
    for pid, depth in zip(point3d_ids.tolist(), depths.tolist()):
        kf, kpt = assignment[pid]
        im = images[kf]
        K = cameras[im.camera_id].K
        uv = im.xys[kpt]
        pc = np.linalg.inv(K) @ np.array([uv[0], uv[1], 1.0]) * depth
        R = im.R()
        pw = R.T @ (pc - im.tvec)
        points3d[pid].xyz = pw

    # reproject all registered keypoints from (refined) 3D points
    for iid, im in images.items():
        reg = np.flatnonzero(im.point3D_ids >= 0)
        if len(reg) == 0:
            continue
        P = np.stack([points3d[int(im.point3D_ids[k])].xyz for k in reg])
        K = cameras[im.camera_id].K
        pc = P @ im.R().T + im.tvec
        uvw = pc @ K.T
        im.xys[reg] = uvw[:, :2] / (uvw[:, 2:3] + 1e-4)


def post_optimize(
    cameras: Dict[int, Camera],
    images: Dict[int, Image],
    points3d: Dict[int, Point3D],
    refine_fn: Callable = None,
    images_px: Dict[int, np.ndarray] = None,
    solver: str = "lm",
    match_capacity: int = 1024,
    max_track_length: int = 16,
    pair_batch: int = 8,
    device: str = "cuda",
) -> dict:
    """Full post-optimization pass over a coarse model (in place).

    When ``refine_fn`` is None the coarse keypoint positions are used as the
    "refined" observations (geometry-only refinement) — useful for tests and
    for pipelines without fine-capable weights.

    Returns a summary dict.
    """
    keyframes, assignment = assign_keyframes_greedy(images, points3d)
    pairs = build_refinement_pairs(images, points3d, keyframes)
    if refine_fn is not None and images_px is not None:
        fine = run_fine_refinement(
            refine_fn, images_px, pairs, match_capacity, pair_batch
        )
    else:
        fine = {
            p.pair: {
                "mkpts0": p.mkpts0,
                "mkpts1_f": p.mkpts1,
                "point3d_ids": p.point3d_ids,
            }
            for p in pairs
        }
    problems = build_depth_problems(
        cameras, images, points3d, assignment, fine, max_track_length
    )
    if len(problems["point3d_ids"]) == 0:
        return {"num_keyframes": len(keyframes), "num_optimized": 0}
    depths = optimize_depths(problems, solver=solver, device=device)
    write_back(
        cameras, images, points3d, assignment, problems["point3d_ids"], depths
    )
    return {
        "num_keyframes": len(keyframes),
        "num_optimized": int(len(problems["point3d_ids"])),
        "mean_depth_change": float(
            np.mean(np.abs(depths - problems["depth0"]))
        ),
    }
