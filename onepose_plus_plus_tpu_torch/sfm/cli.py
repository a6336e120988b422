"""SfM CLI: ``python -m onepose_plus_plus_tpu_torch.sfm +preprocess=sfm_inference_onepose.yaml [overrides]``.

Port of the repository's ``run.py`` (``discover_objects``, ``load_sequence``,
``sfm``): every ``XXXX-name`` object under ``dataset.data_dir`` (restricted to
the config's ``ids``, minus ``exception_obj_names``) gets the keypoint-free SfM
of its mapping sequence, written to ``dataset.outputs_dir/<object>`` with the
same files as ``run.py``. ``device`` (default ``cuda``) names where the
matcher and the geometry run. ``network.loftr_weights`` names a port state
dict (``torch.save`` of ``LoFTRMatcher.state_dict()``); without one the
matcher gets random weights from ``utils.weights.random_state_dict`` and a
warning is printed. Objects are independent: ``OBJ_SHARD`` /
``OBJ_NUM_SHARDS`` split the list across processes.
"""
from __future__ import annotations

import glob
import os
import sys
from pathlib import Path

import numpy as np
import torch

from ..models.build import build_loftr_matcher, make_loftr_fns
from ..utils.config_loader import load_config
from ..utils.weights import random_state_dict
from .runner import SfMConfig, run_sfm

CONFIGS_DIR = Path(__file__).resolve().parents[2] / "configs"


def discover_objects(data_dir: str, ids=None, exception_obj_names=()):
    """Find object dirs named ``XXXX-name`` and their ``name-N`` sequences.

    ``ids`` restricts to the configured split's object-id prefixes and
    ``exception_obj_names`` removes listed objects (reference ``run.py:25-62``
    / preprocess yaml ``ids`` blocks).
    """
    exception_obj_names = {e for e in (exception_obj_names or ()) if e}
    id_set = {str(i) for i in ids} if ids else None
    objects = []
    for obj_dir in sorted(glob.glob(os.path.join(data_dir, "*"))):
        base = os.path.basename(obj_dir)
        if not os.path.isdir(obj_dir) or "-" not in base:
            continue
        if base in exception_obj_names:
            continue
        if id_set is not None and base[:4] not in id_set:
            continue
        name = base.split("-", 1)[1]
        seqs = sorted(glob.glob(os.path.join(obj_dir, f"{name.split('-')[0]}-*")))
        seqs = [s for s in seqs if os.path.isdir(os.path.join(s, "color"))]
        if seqs:
            objects.append((base, seqs))
    return objects


def load_sequence(seq_dir: str):
    """Read a OnePose-format sequence: color/ + intrin_ba/ + poses_ba/ (+Box)."""
    frames = sorted(
        glob.glob(os.path.join(seq_dir, "color", "*.png"))
        + glob.glob(os.path.join(seq_dir, "color", "*.jpg"))
    )
    paths, poses, Ks = [], [], []
    for f in frames:
        stem = os.path.splitext(os.path.basename(f))[0]
        pose_p = os.path.join(seq_dir, "poses_ba", stem + ".txt")
        intr_p = os.path.join(seq_dir, "intrin_ba", stem + ".txt")
        if not (os.path.exists(pose_p) and os.path.exists(intr_p)):
            continue
        paths.append(f)
        poses.append(np.loadtxt(pose_p).reshape(4, 4))
        Ks.append(np.loadtxt(intr_p).reshape(3, 3))
    box_p = os.path.join(os.path.dirname(seq_dir), "box3d_corners.txt")
    corners = np.loadtxt(box_p).reshape(8, 3) if os.path.exists(box_p) else None
    return paths, poses, Ks, corners


def sfm(cfg) -> None:
    objects = discover_objects(
        cfg.dataset.data_dir,
        ids=cfg.get("ids"),
        exception_obj_names=cfg.get("exception_obj_names") or (),
    )
    if not objects:
        print(f"no objects found under {cfg.dataset.data_dir}")
        return
    shard = int(os.environ.get("OBJ_SHARD", "0"))
    n_shards = int(os.environ.get("OBJ_NUM_SHARDS", "1"))
    if n_shards > 1:
        objects = objects[shard::n_shards]
        print(f"shard {shard}/{n_shards}: {len(objects)} objects")
    device = str(cfg.get("device", "cuda"))
    print(f"mapping {len(objects)} object(s) on {device}", flush=True)

    matcher = build_loftr_matcher(dict(cfg.get("model", {}) or {}), device=device)
    weights_path = cfg.get_path("network.loftr_weights")
    if weights_path:
        state = torch.load(weights_path, map_location="cpu", weights_only=True)
    else:
        print("WARNING: no loftr_weights configured — random-weight matcher")
        state = random_state_dict(matcher, seed=666)
    matcher.load_state_dict(state)
    coarse_fn, refine_fn, extract_fn = make_loftr_fns(matcher)

    sfm_cfg = sfm_config(cfg)
    # the reference maps from one sequence (sfm yaml); which one is configurable
    map_idx = int(cfg.dataset.get("mapping_seq_index", 0))
    for obj_name, seqs in objects:
        seq = seqs[map_idx if map_idx < len(seqs) else 0]
        paths, poses, Ks, corners = load_sequence(seq)
        if len(paths) < 2:
            print(f"[{obj_name}] skipped: <2 posed frames")
            continue
        out_dir = os.path.join(cfg.dataset.outputs_dir, obj_name)
        print(f"[{obj_name}] {len(paths)} frames -> {out_dir}")
        stats = run_sfm(paths, poses, Ks, out_dir, coarse_fn, refine_fn=refine_fn,
                        extract_fn=extract_fn, box_corners_3d=corners, cfg=sfm_cfg,
                        device=device)
        print(f"[{obj_name}] {stats}")


def sfm_config(cfg) -> SfMConfig:
    """The run settings of an SfM config (its ``dataset`` and ``sfm`` blocks)."""
    s = cfg.sfm
    return SfMConfig(
        down_ratio=cfg.dataset.down_ratio,
        covis_num=s.covis_num,
        min_rotation_deg=s.min_rotation_deg,
        pair_batch=s.pair_batch,
        max_epipolar_error_px=s.max_epipolar_error_px,
        max_reproj_error_px=s.max_reproj_error_px,
        min_tri_angle_deg=s.min_tri_angle_deg,
        max_track_length=s.max_track_length,
        max_num_kp3d=cfg.dataset.max_num_kp3d,
        merge_dist_threshold=s.merge_dist_threshold,
        solver_type=s.solver_type,
        overwrite=s.overwrite,
        save_vis3d=bool(s.get("save_vis3d", True)),
        match_gallery_num=int(s.get("match_gallery_num", 0)),
    )


def main(argv=None) -> None:
    cfg = load_config(str(CONFIGS_DIR), sys.argv[1:] if argv is None else argv)
    if cfg.get("type") != "sfm":
        raise SystemExit("usage: python -m onepose_plus_plus_tpu_torch.sfm "
                         "+preprocess=<sfm config> [overrides]")
    sfm(cfg)
