"""Annotation merging CLI: ``python -m onepose_plus_plus_tpu_torch.merge +preprocess=merge_anno.yaml``.

Port of the repository's ``merge.py`` (reference ``merge.py``): collect every object's
SfM outputs (``anno_2d.json`` + ``anno_3d_average.npz``) into COCO-style
train/val annotation files consumed by the training dataset
(``records_from_coco`` reads this exact layout back).
"""
from __future__ import annotations

import glob
import json
import os
import sys

from .utils.config_loader import load_config

CONFIGS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


def merge_annotations(sfm_outputs_dir: str, out_file: str, split_objects=None):
    """Build one COCO-style json from per-object anno dirs."""
    images, annotations = [], []
    img_id, ann_id = 0, 0
    for obj_dir in sorted(glob.glob(os.path.join(sfm_outputs_dir, "*"))):
        obj = os.path.basename(obj_dir)
        if split_objects is not None and obj not in split_objects:
            continue
        anno2d_p = os.path.join(obj_dir, "anno", "anno_2d.json")
        anno3d_p = os.path.join(obj_dir, "anno", "anno_3d_average.npz")
        if not (os.path.exists(anno2d_p) and os.path.exists(anno3d_p)):
            continue
        with open(anno2d_p) as f:
            entries = json.load(f)
        for e in entries:
            images.append({"id": img_id, "img_file": e["img_file"]})
            annotations.append(
                {
                    "id": ann_id,
                    "image_id": img_id,
                    "avg_anno3d_file": anno3d_p,
                    "anno2d_file": anno2d_p,
                    "assign_matrix": e["assign_matrix"],
                    "object": obj,
                }
            )
            img_id += 1
            ann_id += 1
    out = {"images": images, "annotations": annotations}
    os.makedirs(os.path.dirname(out_file) or ".", exist_ok=True)
    with open(out_file, "w") as f:
        json.dump(out, f)
    print(f"{out_file}: {len(images)} images from {sfm_outputs_dir}")
    return out


def merge(cfg) -> None:
    print(f"merging annotations from {cfg.dataset.sfm_outputs_dir}", flush=True)
    merge_annotations(
        cfg.dataset.sfm_outputs_dir,
        cfg.dataset.out_train_file,
        split_objects=cfg.get("train_objects"),
    )
    if cfg.get_path("dataset.out_val_file"):
        merge_annotations(
            cfg.dataset.sfm_outputs_dir,
            cfg.dataset.out_val_file,
            split_objects=cfg.get("val_objects"),
        )


def main(argv=None) -> None:
    cfg = load_config(CONFIGS_DIR, sys.argv[1:] if argv is None else argv)
    if cfg.get("type") != "merge":
        raise SystemExit("usage: python -m onepose_plus_plus_tpu_torch.merge "
                         "+preprocess=merge_anno [overrides]")
    merge(cfg)


if __name__ == "__main__":
    main()
