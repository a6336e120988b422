"""Per-object SfM orchestration with stage-artifact caching.

Equivalent of reference ``run.py`` ``sfm_worker``/``sfm_core``/``postprocess``
(:91-395): for one object's mapping sequence, run

  pair generation -> batched LoFTR coarse matching -> merged keypoints ->
  epipolar verification + triangulation (COLMAP replacement) ->
  post-optimization (fine refine + depth LM) -> box/track filtering ->
  feature annotation (anno_3d_average[_coarse].npz + anno_2d.json)

Every stage's output is a file and is skipped when present (the reference's
``overwrite_*`` idempotency story). Port of
``onepose_plus_plus_tpu/sfm/runner.py``: the matcher surfaces come from
``models.build.make_loftr_fns`` (their device is the model's), and the
geometry stages run on ``device``. Stage 5 is skipped only when
``anno/anno_2d.json``, the last file ``build_annotations`` writes, exists
(the JAX package keys it on the first, ``anno_3d_average.npz``, so a run cut
between the two files is never completed).
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.colmap_model import read_model, write_model, model_stats
from ..data.image_io import load_gray_resize_divisible
from .annotation import build_annotations
from .coarse_match import merge_keypoints, run_pairs
from .filtering import (
    filter_by_3d_box,
    filter_track_length,
    merge_close_points,
    track_length_for_budget,
)
from .pairs import pose_covisibility_pairs
from .post_optimization import post_optimize
from .triangulate import triangulate_scene


@dataclasses.dataclass
class SfMConfig:
    down_ratio: int = 5  # keep every Nth frame (reference run.py:112-118)
    covis_num: int = 10
    min_rotation_deg: float = 10.0
    img_resize_max: Optional[int] = None
    df: int = 8
    pair_batch: int = 8
    max_epipolar_error_px: float = 4.0
    max_reproj_error_px: float = 4.0
    min_tri_angle_deg: float = 1.5
    max_track_length: int = 32
    max_num_kp3d: int = 15000
    merge_dist_threshold: float = 1e-3
    box_padding_ratio: float = 0.0
    solver_type: str = "lm"  # 'lm' (DeepLM-equiv) | 'first_order'
    overwrite: bool = False
    # visual-debug artifacts (reference filter_tkl.py:59-89
    # vis_tkl_filtered_pcds + plot_utils.py confidence-colored match plots)
    save_vis3d: bool = True  # vis3d/*.ply pre/post-filter cloud dumps
    match_gallery_num: int = 0  # top-N pairs get confidence-colored plots


def _load_images(
    image_paths: Sequence[str], cfg: SfMConfig
) -> Tuple[Dict[int, np.ndarray], Dict[int, np.ndarray], Dict[int, tuple]]:
    images, scales, sizes = {}, {}, {}
    for i, p in enumerate(image_paths):
        img, scale = load_gray_resize_divisible(p, cfg.img_resize_max, cfg.df)
        images[i] = img
        scales[i] = scale
        sizes[i] = (
            int(round(img.shape[0] * scale[1])),
            int(round(img.shape[1] * scale[0])),
        )
    return images, scales, sizes


def run_sfm(
    image_paths: Sequence[str],
    poses_w2c: Sequence[np.ndarray],
    intrinsics: Sequence[np.ndarray],
    out_dir: str,
    coarse_match_fn: Callable,
    refine_fn: Optional[Callable] = None,
    extract_fn: Optional[Callable] = None,
    box_corners_3d: Optional[np.ndarray] = None,
    cfg: SfMConfig = SfMConfig(),
    device: str = "cuda",
) -> dict:
    """Full SfM for one object. Returns the final stats dict.

    Args:
        image_paths: mapping-sequence frames (already down-sampled upstream
            or down-sampled here by ``cfg.down_ratio``).
        poses_w2c / intrinsics: known per-frame GT/ARKit poses + K
            (the reference's ``poses_ba`` / ``intrin_ba`` inputs).
        coarse_match_fn: batched LoFTR ``match_coarse`` surface.
        refine_fn: batched LoFTR ``refine`` surface (optional).
        extract_fn: optional batched (images [B,H,W,1], kpts [B,K,2], mask) ->
            {"feat_fine" [B,K,128], "feat_coarse" [B,K,256]} descriptor
            sampler for annotation building.
        box_corners_3d: [8, 3] object box for point filtering (optional).
        device: where verification, triangulation and the depth solver run.
    """
    os.makedirs(out_dir, exist_ok=True)
    sel = list(range(0, len(image_paths), cfg.down_ratio))
    image_paths = [image_paths[i] for i in sel]
    poses = {i: np.asarray(poses_w2c[s]) for i, s in enumerate(sel)}
    Ks = {i: np.asarray(intrinsics[s]) for i, s in enumerate(sel)}
    names = {i: os.path.basename(p) for i, p in enumerate(image_paths)}

    model_coarse_dir = os.path.join(out_dir, "model_coarse")
    model_refined_dir = os.path.join(out_dir, "model")
    filtered_dir = os.path.join(out_dir, "model_filted_bbox")
    anno_dir = os.path.join(out_dir, "anno")
    matches_path = os.path.join(out_dir, "raw_matches.pkl")

    # ---- stage 1: pairs + coarse matching (cached as raw_matches.pkl)
    if cfg.overwrite or not os.path.exists(matches_path):
        images, scales, sizes = _load_images(image_paths, cfg)
        pairs = pose_covisibility_pairs(
            [poses[i] for i in range(len(image_paths))],
            num_matched=cfg.covis_num,
            min_rotation_deg=cfg.min_rotation_deg,
        )
        raw = run_pairs(
            coarse_match_fn, images, scales, pairs, pair_batch=cfg.pair_batch
        )
        with open(matches_path, "wb") as f:
            pickle.dump({"raw": raw, "sizes": sizes}, f)
    else:
        with open(matches_path, "rb") as f:
            blob = pickle.load(f)
        raw, sizes = blob["raw"], blob["sizes"]
        images = None

    if cfg.match_gallery_num > 0:
        if images is None:
            images, scales, _ = _load_images(image_paths, cfg)
        save_match_gallery(
            raw, images, scales, os.path.join(out_dir, "vis3d", "matches"),
            names, top_n=cfg.match_gallery_num,
        )

    # ---- stage 2: merge + verify + triangulate (cached as model_coarse)
    if cfg.overwrite or not os.path.exists(
        os.path.join(model_coarse_dir, "cameras.bin")
    ):
        scene = merge_keypoints(raw)
        export_hloc_artifacts(scene, names, out_dir)
        tri = triangulate_scene(
            scene,
            Ks,
            poses,
            sizes,
            image_names=names,
            max_error_px=cfg.max_epipolar_error_px,
            max_reproj_px=cfg.max_reproj_error_px,
            min_tri_angle_deg=cfg.min_tri_angle_deg,
            max_track_length=cfg.max_track_length,
            device=device,
        )
        cameras, imgs, points3d = tri.cameras, tri.images, tri.points3d
        write_model(cameras, imgs, points3d, model_coarse_dir)
    else:
        cameras, imgs, points3d = read_model(model_coarse_dir)

    # ---- stage 3: post-optimization (cached as model/)
    if cfg.overwrite or not os.path.exists(
        os.path.join(model_refined_dir, "cameras.bin")
    ):
        if images is None:
            images, _, _ = _load_images(image_paths, cfg)
        summary = post_optimize(
            cameras,
            imgs,
            points3d,
            refine_fn=refine_fn,
            images_px=images,
            solver=cfg.solver_type,
            device=device,
        )
        write_model(cameras, imgs, points3d, model_refined_dir)
        with open(os.path.join(out_dir, "post_optimize.json"), "w") as f:
            json.dump(summary, f)
    else:
        cameras, imgs, points3d = read_model(model_refined_dir)

    # ---- stage 4: filtering
    if cfg.save_vis3d:
        save_cloud_ply(
            points3d, os.path.join(out_dir, "vis3d", "point_cloud_pre_filter.ply")
        )
    if box_corners_3d is not None:
        points3d = filter_by_3d_box(
            imgs, points3d, box_corners_3d, cfg.box_padding_ratio
        )
    tkl = track_length_for_budget(points3d, cfg.max_num_kp3d)
    points3d = filter_track_length(imgs, points3d, tkl)
    points3d = merge_close_points(imgs, points3d, cfg.merge_dist_threshold)
    write_model(cameras, imgs, points3d, filtered_dir)
    if cfg.save_vis3d:
        # post-filter cloud colored by track length (reference
        # vis_tkl_filtered_pcds, filter_tkl.py:59-89)
        save_cloud_ply(
            points3d,
            os.path.join(out_dir, "vis3d", "point_cloud_post_filter.ply"),
            color_by_track_length=True,
        )

    # ---- stage 5: feature annotation (cached as anno/ — idempotent like
    # stages 1-3; anno_2d.json is the last file build_annotations writes, so
    # its presence means the whole stage finished)
    anno_done = os.path.exists(os.path.join(anno_dir, "anno_2d.json"))
    if not cfg.overwrite and anno_done:
        stats = model_stats(cameras, imgs, points3d)
        stats["min_track_length"] = tkl
        with open(os.path.join(out_dir, "stats.json"), "w") as f:
            json.dump(stats, f)
        return stats
    if extract_fn is not None:
        if images is None:
            images, _, _ = _load_images(image_paths, cfg)
        fine_desc, coarse_desc = extract_keypoint_descriptors(
            extract_fn, images, imgs
        )
    else:
        # descriptor-less fallback: zeros (keeps artifact layout intact)
        fine_desc = {
            i: np.zeros((len(im.xys), 128), np.float32) for i, im in imgs.items()
        }
        coarse_desc = {
            i: np.zeros((len(im.xys), 256), np.float32) for i, im in imgs.items()
        }
    build_annotations(
        imgs,
        points3d,
        fine_desc,
        coarse_descriptors=coarse_desc,
        out_dir=anno_dir,
        # absolute frame paths so anno_2d.json/merge.py records are loadable
        # by the training dataset (image id == index into the mapping list)
        image_paths={i: os.path.abspath(p) for i, p in enumerate(image_paths)},
    )

    stats = model_stats(cameras, imgs, points3d)
    stats["min_track_length"] = tkl
    with open(os.path.join(out_dir, "stats.json"), "w") as f:
        json.dump(stats, f)
    return stats


def extract_keypoint_descriptors(
    extract_fn: Callable,
    images_px: Dict[int, np.ndarray],
    colmap_images,
    batch: int = 8,
    kpt_capacity: int = 4096,
) -> Tuple[Dict[int, np.ndarray], Dict[int, np.ndarray]]:
    """Sample backbone descriptors at every image's keypoints, batched.

    ``extract_fn``: batched (img [B,H,W,1], kpts [B,K,2] pixel xy, mask) ->
    {"feat_fine" [B,K,Df], "feat_coarse" [B,K,Dc]}.
    """
    ids = sorted(colmap_images.keys())
    fine_out, coarse_out = {}, {}
    for s in range(0, len(ids), batch):
        chunk = ids[s : s + batch]
        pad = batch - len(chunk)
        chunk_p = chunk + [chunk[-1]] * pad
        img = np.stack([images_px[i][..., None] for i in chunk_p])
        kpts = np.zeros((batch, kpt_capacity, 2), np.float32)
        mask = np.zeros((batch, kpt_capacity), bool)
        for bi, i in enumerate(chunk_p):
            xys = colmap_images[i].xys
            m = min(len(xys), kpt_capacity)
            kpts[bi, :m] = xys[:m]
            mask[bi, :m] = True
        res = extract_fn(img, kpts, mask)
        ff = np.asarray(res["feat_fine"])
        fc = np.asarray(res["feat_coarse"])
        for bi, i in enumerate(chunk):
            m = min(len(colmap_images[i].xys), kpt_capacity)
            fine_out[i] = ff[bi, :m]
            coarse_out[i] = fc[bi, :m]
    return fine_out, coarse_out


def save_cloud_ply(
    points3d, path: str, color_by_track_length: bool = False
) -> None:
    """Dump a COLMAP point dict as PLY for visual debugging.

    Equivalent of the reference's Wis3D point-cloud dumps
    (``post_optimization/utils/vis3d.py:1-47``) and the track-length-colored
    filtered clouds (``filter_tkl.py:59-89`` ``vis_tkl_filtered_pcds``), as
    portable PLY files instead of a Wis3D server.
    """
    from ..utils.visualization import save_ply

    pts = np.array([p.xyz for p in points3d.values()], np.float32).reshape(-1, 3)
    colors = None
    if len(pts) and color_by_track_length:
        tkl = np.array([len(p.image_ids) for p in points3d.values()], np.float64)
        t = (tkl - tkl.min()) / max(tkl.max() - tkl.min(), 1e-9)
        # short tracks blue -> long tracks red (no matplotlib dependency)
        colors = np.stack(
            [255 * t, 64 * np.ones_like(t), 255 * (1 - t)], axis=1
        ).astype(np.uint8)
    elif len(pts):
        colors = np.array([p.rgb for p in points3d.values()], np.uint8)
    save_ply(path, pts, colors)


def save_match_gallery(
    raw, images, scales, out_dir: str, names: Dict[int, str], top_n: int = 6
) -> None:
    """Confidence-colored match plots for the top-N pairs by match count
    (reference ``src/utils/plot_utils.py`` make_matching_plot gallery)."""
    import cv2

    from ..utils.plotting import plot_image_pair_matches

    os.makedirs(out_dir, exist_ok=True)
    ranked = sorted(raw, key=lambda pm: -len(pm.conf))[:top_n]
    for pm in ranked:
        i, j = pm.pair
        # PairMatches coords are original-image pixels; images are net-scale
        p0 = pm.pts0 / np.asarray(scales[i])[None, :]
        p1 = pm.pts1 / np.asarray(scales[j])[None, :]
        conf = pm.conf
        cmax = float(conf.max()) if len(conf) else 1.0
        arr = plot_image_pair_matches(
            images[i], images[j], p0, p1, mconf=conf / max(cmax, 1e-9)
        )
        n0 = os.path.splitext(names.get(i, str(i)))[0]
        n1 = os.path.splitext(names.get(j, str(j)))[0]
        cv2.imwrite(
            os.path.join(out_dir, f"{n0}_{n1}.png"), arr[..., ::-1]
        )


def export_hloc_artifacts(scene, names: Dict[int, str], out_dir: str) -> None:
    """Write hloc-style feature/match h5 artifacts for ecosystem interop.

    The reference persists its coarse-matching results as
    ``feats-loftr.h5`` (per-image keypoints + fake zero descriptors/scores,
    ``coarse_match.py:189-214``) and ``matches-loftr.h5`` (per-pair index
    matches keyed "name0_name1"); downstream hloc tooling reads these.
    """
    import numpy as np

    from ..data.image_io import grouped_save_h5

    feats = {}
    for img_id, kpts in scene.keypoints.items():
        feats[names[img_id]] = {
            "keypoints": kpts.astype(np.float32),
            # the reference writes fake descriptors/scores for hloc schema
            # compatibility (real descriptors live in the 3D annotation)
            "descriptors": np.zeros((256, len(kpts)), np.float32),
            "scores": scene.scores[img_id].astype(np.float32),
        }
    grouped_save_h5(feats, os.path.join(out_dir, "feats-loftr.h5"))

    matches = {}
    for (i, j), m in scene.match_indices.items():
        key = f"{names[i]}_{names[j]}"
        matches[key] = {
            "matches": m.astype(np.int64),
            "matching_scores": scene.match_confs[(i, j)].astype(np.float32),
        }
    grouped_save_h5(matches, os.path.join(out_dir, "matches-loftr.h5"))
