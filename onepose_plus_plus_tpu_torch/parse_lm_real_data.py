"""LINEMOD -> OnePose format converter: ``python -m onepose_plus_plus_tpu_torch.parse_lm_real_data ...``.

Port of the repository's ``parse_lm_real_data.py`` (reference
``parse_lm_real_data.py``): converts a
LINEMOD object (BOP-style layout: rgb/, poses as gt annotations, intrinsics)
into the OnePose directory format (``color/ intrin_ba/ poses_ba/ bbox/`` 256^2
crops) under ids 0801-0815 (``id2name_dict``), using GT boxes (optionally with
detector noise) or external YOLO boxes.
"""
from __future__ import annotations

import argparse
import json
import os.path as osp
from glob import glob
from pathlib import Path

import numpy as np

from .data.preprocessing import crop_img_by_bbox, square_bbox

ID2NAME = {
    1: "ape", 2: "benchvise", 4: "camera", 5: "can", 6: "cat",
    8: "driller", 9: "duck", 10: "eggbox", 11: "glue", 12: "holepuncher",
    13: "iron", 14: "lamp", 15: "phone",
}


def parse_models_info(path):
    """models_info.txt: per-object diameter + extents (BOP format)."""
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split(" ")
            if not parts or not parts[0].isdigit():
                continue
            obj_id = int(parts[0])
            kv = {}
            for k, v in zip(parts[1::2], parts[2::2]):
                kv[k] = float(v)
            out[obj_id] = kv
    return out


def load_gt_poses(scene_gt_path):
    with open(scene_gt_path) as f:
        gt = json.load(f)
    poses = {}
    for frame_id, anns in gt.items():
        a = anns[0]
        T = np.eye(4)
        T[:3, :3] = np.asarray(a["cam_R_m2c"]).reshape(3, 3)
        T[:3, 3] = np.asarray(a["cam_t_m2c"]).reshape(3) / 1000.0  # mm -> m
        poses[int(frame_id)] = T
    return poses


def load_camera(scene_camera_path):
    with open(scene_camera_path) as f:
        cams = json.load(f)
    Ks = {}
    for frame_id, c in cams.items():
        Ks[int(frame_id)] = np.asarray(c["cam_K"]).reshape(3, 3)
    return Ks


def convert_object(
    data_base_dir: str,
    obj_id: int,
    onepose_id: str,
    output_dir: str,
    split: str = "train",
    crop_size: int = 256,
    add_detector_noise: bool = False,
    yolo_box_dir: str = None,
):
    import cv2

    name = ID2NAME[obj_id]
    obj_dir = osp.join(data_base_dir, f"{obj_id:06d}")
    if not osp.isdir(obj_dir):
        obj_dir = osp.join(data_base_dir, name)
    rgb_dir = osp.join(obj_dir, "rgb")
    poses = load_gt_poses(osp.join(obj_dir, "scene_gt.json"))
    Ks = load_camera(osp.join(obj_dir, "scene_camera.json"))

    out_seq = osp.join(output_dir, f"{onepose_id}-lm{obj_id}-others", f"lm{obj_id}-1")
    for sub in ("color", "intrin_ba", "poses_ba", "bbox"):
        Path(osp.join(out_seq, sub)).mkdir(parents=True, exist_ok=True)

    # model points for bbox projection
    info = parse_models_info(osp.join(data_base_dir, "models", "models_info.txt")) \
        if osp.exists(osp.join(data_base_dir, "models", "models_info.txt")) else {}
    rng = np.random.default_rng(0)
    n = 0
    for img_p in sorted(glob(osp.join(rgb_dir, "*.png"))):
        fid = int(osp.splitext(osp.basename(img_p))[0])
        if fid not in poses or fid not in Ks:
            continue
        T, K = poses[fid], Ks[fid]
        img = cv2.imread(img_p, cv2.IMREAD_COLOR)
        if obj_id in info:
            i = info[obj_id]
            lo = np.array([i["min_x"], i["min_y"], i["min_z"]]) / 1000.0
            sz = np.array([i["size_x"], i["size_y"], i["size_z"]]) / 1000.0
            corners = np.array(
                [lo + sz * np.array([x, y, z]) for x in (0, 1) for y in (0, 1) for z in (0, 1)]
            )
            pc = corners @ T[:3, :3].T + T[:3, 3]
            uv = (pc @ K.T)[:, :2] / (pc @ K.T)[:, 2:3]
            bbox = np.array([uv[:, 0].min(), uv[:, 1].min(), uv[:, 0].max(), uv[:, 1].max()])
        else:
            bbox = np.array([0, 0, img.shape[1], img.shape[0]], np.float64)
        if yolo_box_dir:
            yolo_p = osp.join(yolo_box_dir, name, f"{fid:06d}.txt")
            if osp.exists(yolo_p):
                bbox = np.loadtxt(yolo_p).reshape(4)
        if add_detector_noise:
            wh = np.array([bbox[2] - bbox[0], bbox[3] - bbox[1]])
            bbox = bbox + rng.uniform(-0.1, 0.1, 4) * np.concatenate([wh, wh])
        bbox = square_bbox(bbox, pad_ratio=0.1)
        crop, K_crop = crop_img_by_bbox(img, bbox, K, crop_size)
        cv2.imwrite(osp.join(out_seq, "color", f"{fid}.png"), crop)
        np.savetxt(osp.join(out_seq, "intrin_ba", f"{fid}.txt"), K_crop)
        np.savetxt(osp.join(out_seq, "poses_ba", f"{fid}.txt"), T)
        np.savetxt(osp.join(out_seq, "bbox", f"{fid}.txt"), bbox)
        n += 1
    print(f"{name} ({onepose_id}): {n} frames -> {out_seq}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m onepose_plus_plus_tpu_torch.parse_lm_real_data")
    ap.add_argument("--data_base_dir", default="data/LINEMOD")
    ap.add_argument("--obj_id", type=int, default=1)
    ap.add_argument("--split", default="train", choices=["train", "val"])
    ap.add_argument("--assign_onepose_id", default="0801")
    ap.add_argument("--add_detector_noise", action="store_true")
    ap.add_argument("--use_yolo_box", action="store_true")
    ap.add_argument("--yolo_box_base_path", default="data/LINEMOD/yolo_detection")
    ap.add_argument("--output_data_dir", default="data/datasets/LM_dataset")
    ap.add_argument("--crop_size", type=int, default=256)
    args = ap.parse_args(argv)
    convert_object(
        args.data_base_dir,
        args.obj_id,
        args.assign_onepose_id,
        args.output_data_dir,
        split=args.split,
        crop_size=args.crop_size,
        add_detector_noise=args.add_detector_noise,
        yolo_box_dir=args.yolo_box_base_path if args.use_yolo_box else None,
    )


if __name__ == "__main__":
    main()
