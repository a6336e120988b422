"""Tiny versions of the cells for CPU tests: narrow widths, small images, few
points; the structure of each configuration and traffic file kept."""
from __future__ import annotations

import copy
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def load(rel: str) -> dict:
    return json.loads((BENCH / rel).read_text())


def query_config() -> dict:
    cfg = copy.deepcopy(load("configs/onepose_query.json"))
    m = cfg["model"]
    m["compute_dtype"] = "float32"
    m["loftr_backbone"].update(initial_dim=16, block_dims=[16, 24, 32])
    m["keypoints_encoding"].update(descriptor_dim=32, keypoints_encoder=[8, 16])
    m["loftr_coarse"].update(d_model=32, nhead=4)
    m["match_coarse"].update(max_matches=48)
    m["loftr_fine"].update(d_model=16, nhead=4)
    cfg["inference"]["num_hypotheses"] = 64
    return cfg


def query_traffic() -> dict:
    t = copy.deepcopy(load("workloads/query_eval_fb48.json"))
    t.update(objects=2, frames_per_object=6, frame_batch=4, img=96, shape3d=240, ref_views=3, point_margin_px=8)
    t["object"].update(focal=93.75, tex_blocks=16, tex_block_px=8)
    t["check"].update(frames=6, ref_block=3, fine_frames=2)
    return t


def sfm_config() -> dict:
    cfg = copy.deepcopy(load("configs/loftr_sfm.json"))
    cfg["model"].update(compute_dtype="float32")
    cfg["model"]["match_coarse"].update(max_matches=64, thr=0.0)
    return cfg


def sfm_traffic() -> dict:
    t = copy.deepcopy(load("workloads/sfm_match_pb8.json"))
    t.update(frames_per_object=5, img=64, pair_batch=2, covis_num=2)
    t["object"].update(focal=62.5, tex_blocks=16, tex_block_px=8)
    t["check"].update(batches=1, fine_units=1, fine_pairs=1)
    return t


def train_config() -> dict:
    cfg = copy.deepcopy(load("configs/onepose_train.json"))
    cfg["model"] = query_config()["model"]
    cfg["model"]["match_coarse"].update(thr=0.1, train_max_matches=40, train_pad_num_gt_min=10)
    cfg["trainer"]["batch_size"] = 2
    return cfg


def train_traffic() -> dict:
    t = copy.deepcopy(load("workloads/train_mb4.json"))
    t.update(pool=6, img=64, shape3d=100)
    t["scene"].update(focal=62.5)
    return t
