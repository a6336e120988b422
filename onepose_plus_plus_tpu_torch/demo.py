"""Tracking demo: ``python -m onepose_plus_plus_tpu_torch.demo +experiment=inference_demo.yaml [overrides]``.

Port of the repository's ``demo.py``: sequential tracking over the last
sequence of the first object under ``dataset.data_dir`` that has an SfM
annotation. On frame 0, and whenever the previous frame's PnP had fewer than
``demo.min_track_inliers`` inliers (or failed), the detector matches
``demo.num_ref_views`` DB views (frames of the SfM model, from the object's
first sequence) against the full frame with LoFTR's ``match_coarse``;
otherwise the object's 3D box projected with the previous pose gives the
crop. Each frame is then one batch-1 query step (matcher with kernels K1-K3,
RANSAC-PnP), drawn with its 3D box to ``demo.frames_dir`` (default
``artifacts/demo/<object>``) and assembled into ``demo.output_video``.

``device`` (default ``cuda``) names where the models run. The point cloud is
uploaded once. ``network.onepose_weights`` and ``network.loftr_weights`` name
port ``.pt`` or reference ``.ckpt`` files; without them the models get random
weights (seed 666). RANSAC's generator is seeded 0, the point cloud's
subsample 666, as the JAX demo seeds its keys.
"""
from __future__ import annotations

import glob
import os
import sys
import time

import numpy as np
import torch

from .data.colmap_model import read_model
from .data.dataset import OnePosePlusInferenceDataset
from .data.image_io import imread_gray, resize_image
from .data.preprocessing import pad_point_cloud
from .inference.cli import CONFIGS_DIR, load_or_random_weights, sequence_records
from .inference.detector import LocalFeatureObjectDetector
from .inference.pipeline import make_query_step
from .models.build import build_loftr_matcher, build_onepose_model, make_loftr_fns
from .utils.config_loader import load_config
from .utils.visualization import make_video, save_demo_frame


def demo(cfg):
    """Run the tracking loop; returns one record per frame: ``mode``
    (``detect`` or ``track``), ``inliers``, ``ok``, ``pose`` (4x4 world to
    camera) and ``seconds`` (from the frame's start to its pose on the host,
    synchronised)."""
    data_dir = cfg.dataset.data_dir
    sfm_dir = cfg.dataset.sfm_outputs_dir
    obj_dirs = [
        d for d in sorted(glob.glob(os.path.join(data_dir, "*")))
        if os.path.isdir(d)
        and os.path.exists(os.path.join(sfm_dir, os.path.basename(d), "anno", "anno_3d_average.npz"))
    ]
    if not obj_dirs:
        print(f"no demo objects under {data_dir}")
        return []
    obj_dir = obj_dirs[0]
    obj_name = os.path.basename(obj_dir)
    device = str(cfg.get("device", "cuda"))
    print(f"demo: {obj_name} on {device}", flush=True)
    anno_path = os.path.join(sfm_dir, obj_name, "anno", "anno_3d_average.npz")
    seqs = [s for s in sorted(glob.glob(os.path.join(obj_dir, "*")))
            if os.path.isdir(os.path.join(s, "color"))]
    records = sequence_records(seqs[-1])
    img_size = cfg.dataset.img_resize
    ds = OnePosePlusInferenceDataset(anno_path, records, img_size, demo_mode=True)

    box_p = os.path.join(obj_dir, "box3d_corners.txt")
    corners = (np.loadtxt(box_p).reshape(8, 3) if os.path.exists(box_p)
               else _bbox_corners_from_points(ds.annotation["keypoints3d"]))

    model = build_onepose_model(dict(cfg.get("model", {}) or {}), device=device)
    load_or_random_weights(model, cfg.get_path("network.onepose_weights"), "onepose_weights")
    matcher = build_loftr_matcher(device=device)
    load_or_random_weights(matcher, cfg.get_path("network.loftr_weights"), "loftr_weights")
    coarse_fn = make_loftr_fns(matcher)[0]

    # DB views: frames of the SfM model's images, from the mapping sequence
    model_dir = os.path.join(sfm_dir, obj_name, "model")
    db_views = []
    if os.path.exists(os.path.join(model_dir, "cameras.bin")):
        _, imgs, _ = read_model(model_dir)
        names = [im.name for im in imgs.values()]
        step = max(1, len(names) // cfg.demo.num_ref_views)
        for name in names[::step][: cfg.demo.num_ref_views]:
            p = os.path.join(seqs[0], "color", name)
            if os.path.exists(p):
                db_views.append(resize_image(imread_gray(p), (img_size, img_size)))
    if not db_views:
        db_views = [np.zeros((img_size, img_size), np.float32)]
    detector = LocalFeatureObjectDetector(coarse_fn, np.stack(db_views), output_size=img_size)

    shape3d = cfg.dataset.shape3d
    anno = ds.annotation
    pc = pad_point_cloud(anno["keypoints3d"], anno["descriptors3d"], anno.get("scores3d"), shape3d,
                         np.random.default_rng(666))
    # the point cloud: one upload for the whole video (the step broadcasts
    # unbatched [S, ...] entries)
    pc_dev = {k: torch.from_numpy(pc[k]).to(device) for k in ("keypoints3d", "descriptors3d")}
    if "descriptors3d_coarse" in anno:
        pc_dev["descriptors3d_coarse"] = torch.from_numpy(pad_point_cloud(
            anno["keypoints3d"], anno["descriptors3d_coarse"], None, shape3d,
            np.random.default_rng(666))["descriptors3d"]).to(device)
    step = make_query_step(model, reproj_threshold_px=cfg.demo.pnp_reproj_thr,
                           num_hypotheses=cfg.demo.num_hypotheses)
    generator = torch.Generator(device=device)
    generator.manual_seed(0)
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)

    out_dir = cfg.get_path("demo.frames_dir") or os.path.join("artifacts", "demo", obj_name)
    frame_paths, log = [], []
    pose_prev, inliers_prev = None, 0
    for fid in range(len(ds)):
        f = ds[fid]
        sync()
        t0 = time.perf_counter()
        if pose_prev is None or inliers_prev < cfg.demo.min_track_inliers:
            mode = "detect"
            crop, K_crop, _, _ = detector.detect(f["image"], f["K"], generator)
        else:
            mode = "track"
            crop, K_crop, _ = detector.previous_pose_detect(f["image"], f["K"], pose_prev, corners)
        batch = {
            "query_image": torch.from_numpy(np.ascontiguousarray(crop[None, ..., None], np.float32)).to(device),
            "intrinsics": torch.from_numpy(K_crop[None].astype(np.float32)).to(device),
            **pc_dev,
        }
        poses, n_inl, ok = step(batch, generator, None)[:3]
        pose = poses[0].cpu().numpy()
        inliers_prev, ok = int(n_inl[0]), bool(ok[0])
        seconds = time.perf_counter() - t0
        pose_prev = pose if ok else None
        log.append({"frame": fid, "mode": mode, "inliers": inliers_prev, "ok": ok, "seconds": seconds,
                    "pose": pose})
        fp = os.path.join(out_dir, f"{fid:06d}.png")
        save_demo_frame(f["image"], pose, f["K"], corners, fp, inliers_prev)
        frame_paths.append(fp)
        if fid % 25 == 0:
            print(f"frame {fid}/{len(ds)} inliers={inliers_prev}")

    make_video(frame_paths, cfg.demo.output_video)
    print(f"demo video -> {cfg.demo.output_video}")
    return log


def _bbox_corners_from_points(pts: np.ndarray) -> np.ndarray:
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    return np.array(
        [
            [lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
            [hi[0], hi[1], lo[2]], [lo[0], hi[1], lo[2]],
            [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
            [hi[0], hi[1], hi[2]], [lo[0], hi[1], hi[2]],
        ]
    )


def main(argv=None) -> None:
    cfg = load_config(str(CONFIGS_DIR), sys.argv[1:] if argv is None else argv)
    if cfg.get("type") is None:
        raise SystemExit("usage: python -m onepose_plus_plus_tpu_torch.demo +experiment=inference_demo.yaml")
    demo(cfg)


if __name__ == "__main__":
    main()
