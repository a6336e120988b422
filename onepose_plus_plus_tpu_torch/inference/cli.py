"""Evaluation CLI: ``python -m onepose_plus_plus_tpu_torch.inference +experiment=inference_onepose.yaml [overrides]``.

Port of the repository's ``inference.py``: every evaluable object (test
sequences and an SfM annotation) goes through the batched query step
(``inference/pipeline.py``: the matcher with kernels K1-K3, RANSAC-PnP, the
pose errors) and the CLI writes the same files to ``output_dir``:
``metrics.txt`` in the reference's block layout, ending in ``ALL: {...}``, and
``errors_<object>.json`` with the per-frame errors, inliers and matches. With
``eval_metrics.eval_ADD_metric`` it adds ADD(S)-0.1d and proj2D against the
object's CAD model. ``device`` (default ``cuda``) names where the model runs.
``network.onepose_weights`` names a port ``.pt`` or a reference ``.ckpt``
(``utils.checkpoint.load_weights``); without one the model gets random weights
from ``utils.weights.random_state_dict`` (seed 666) and a warning is printed.
``profiler_name`` (none, simple, advanced, chrome) times each object and
writes the advanced profiler's ``.pstats`` files and the chrome trace to
``output_dir``.
"""
from __future__ import annotations

import glob
import json
import os
import sys
from pathlib import Path

import numpy as np

from ..data.dataset import FrameRecord, OnePosePlusInferenceDataset
from ..eval.metrics import aggregate_metrics
from ..models.build import build_onepose_model
from ..utils.checkpoint import load_weights
from ..utils.config_loader import load_config
from ..utils.profiling import build_profiler
from ..utils.weights import random_state_dict
from .pipeline import make_query_step, run_inference

CONFIGS_DIR = Path(__file__).resolve().parents[2] / "configs"


def discover_eval_objects(
    data_dir: str,
    sfm_dir: str,
    ids=None,
    exception_obj_names=(),
    top_k_obj=None,
    num_val_seq=None,
):
    """Objects with test sequences and an SfM annotation.

    Mirrors the reference discovery (its ``inference.py:22-81``):
    objects are ``XXXX-name`` dirs, optionally restricted to the configured
    test-split ``ids`` (matched on the 4-char id prefix) minus
    ``exception_obj_names``; per object the evaluated sequences are every
    ``name-seq`` dir (excluding ``-demo``), or only the LAST ``num_val_seq``
    of them when set (reference ``num_val_seq: 1``).
    """
    names = sorted(os.listdir(data_dir)) if os.path.isdir(data_dir) else []
    names = [n for n in names[top_k_obj:] if "-" in n]
    if ids:
        id2full = {n[:4]: n for n in names}
        names = [id2full[i] for i in ids if i in id2full]
    exception_obj_names = {e for e in (exception_obj_names or ()) if e}
    out = []
    for base in names:
        if base in exception_obj_names:
            continue
        obj_dir = os.path.join(data_dir, base)
        anno = os.path.join(sfm_dir, base, "anno", "anno_3d_average.npz")
        if not (os.path.isdir(obj_dir) and os.path.exists(anno)):
            continue
        seqs = [
            s
            for s in sorted(glob.glob(os.path.join(obj_dir, "*")))
            if os.path.isdir(os.path.join(s, "color"))
            and "-" in os.path.basename(s)
            and "-demo" not in os.path.basename(s)
        ]
        if num_val_seq:
            seqs = seqs[-int(num_val_seq):]
        if seqs:
            out.append((base, seqs, anno))
    return out


def sequence_records(seq_dir: str):
    recs = []
    for f in sorted(
        glob.glob(os.path.join(seq_dir, "color", "*.png"))
        + glob.glob(os.path.join(seq_dir, "color", "*.jpg"))
    ):
        stem = os.path.splitext(os.path.basename(f))[0]
        pose_p = os.path.join(seq_dir, "poses_ba", stem + ".txt")
        intr_p = os.path.join(seq_dir, "intrin_ba", stem + ".txt")
        if not os.path.exists(intr_p):
            intr_p = os.path.join(seq_dir, "intrin", stem + ".txt")
        if not os.path.exists(intr_p):
            continue
        rec = FrameRecord(
            img_file=f, K=np.loadtxt(intr_p).reshape(3, 3)
        )
        if os.path.exists(pose_p):
            rec.pose = np.loadtxt(pose_p).reshape(4, 4)
        recs.append(rec)
    return recs


def load_or_random_weights(model, path, what: str) -> None:
    """``load_weights(path, model)``, or random weights (seed 666) with the
    CLIs' warning when no path is configured."""
    if path:
        load_weights(path, model)
    else:
        print(f"WARNING: no {what} — random-weight model")
        model.load_state_dict(random_state_dict(model, seed=666))


def _add_metrics(cfg, obj_name, frames, res):
    """ADD(S)-0.1d and proj2D flags of every GT frame against the object's CAD
    model (the LINEMOD path, reference ``inference_LINEMOD.yaml``), or None
    when the object has no CAD model."""
    from ..eval import SYMMETRIC_OBJ_IDS, add_metric, load_cad_for_eval, projection_2d_error

    cad_dir = cfg.get_path("cad.cad_models_dir", cfg.get_path("dataset.cad_models_dir", ""))
    obj_id = obj_name.split("-")[0]
    cad_path = os.path.join(cad_dir, f"{obj_name}.ply")
    if not os.path.exists(cad_path):
        cad_path = os.path.join(cad_dir, f"{obj_id}.ply")
    if not os.path.exists(cad_path):
        return None
    model_pts, diameter = load_cad_for_eval(
        cad_path, unit_scale=cfg.get_path("cad.cad_unit_scale", cfg.get_path("dataset.cad_unit_scale", 1.0)))
    symmetric = obj_id in SYMMETRIC_OBJ_IDS
    add_flags, proj_flags = [], []
    for fi, f in enumerate(frames):
        if "pose_gt" not in f:
            continue
        add_flags.append(add_metric(res.poses[fi], f["pose_gt"], model_pts, diameter, symmetric=symmetric))
        proj_flags.append(projection_2d_error(res.poses[fi], f["pose_gt"], model_pts, f["K"]))
    return aggregate_metrics(res.R_errs, res.t_errs, add_flags=add_flags, proj2d_flags=proj_flags,
                             pose_thresholds=tuple(cfg.eval_metrics.pose_thresholds))


def inference(cfg) -> None:
    objects = discover_eval_objects(
        cfg.dataset.data_dir,
        cfg.dataset.sfm_outputs_dir,
        ids=cfg.get("ids"),
        exception_obj_names=cfg.get("exception_obj_names") or (),
        top_k_obj=cfg.get("top_k_obj"),
        num_val_seq=cfg.get("num_val_seq"),
    )
    if not objects:
        print(f"no evaluable objects under {cfg.dataset.data_dir}")
        return
    device = str(cfg.get("device", "cuda"))
    print(f"evaluating {len(objects)} object(s) on {device}: {[o[0] for o in objects]}", flush=True)

    model = build_onepose_model(dict(cfg.get("model", {}) or {}), device=device)
    load_or_random_weights(model, cfg.get_path("network.onepose_weights"), "onepose_weights")
    step = make_query_step(
        model,
        reproj_threshold_px=cfg.eval_metrics.pnp_reproj_thr,
        num_hypotheses=cfg.inference.num_hypotheses,
        p3p_samples=int(cfg.inference.get("p3p_samples", 128)),
    )
    out_dir = cfg.get("output_dir", "results")
    os.makedirs(out_dir, exist_ok=True)
    profiler = build_profiler(cfg.get("profiler_name"))
    pose_thresholds = tuple(cfg.eval_metrics.pose_thresholds)
    all_R, all_t, per_object = [], [], {}

    for obj_name, seqs, anno_path in objects:
        # every selected test sequence, pooled per object (reference
        # data_dirs = "obj_dir seq1 seq2 ...", inference.py:75-78)
        records = [r for s in seqs for r in sequence_records(s)]
        ds = OnePosePlusInferenceDataset(anno_path, records, img_size=cfg.dataset.img_resize)
        with profiler.record(f"inference/{obj_name}"):
            res = run_inference(
                model, ds.frames(), ds.annotation,
                shape3d=cfg.dataset.shape3d,
                frame_batch=cfg.inference.frame_batch,
                reproj_threshold_px=cfg.eval_metrics.pnp_reproj_thr,
                num_hypotheses=cfg.inference.num_hypotheses,
                pose_thresholds=pose_thresholds,
                step=step,
            )
        if cfg.get_path("eval_metrics.eval_ADD_metric") and res.R_errs is not None:
            res.metrics = _add_metrics(cfg, obj_name, list(ds.frames()), res) or res.metrics
        per_object[obj_name] = res.metrics
        if res.R_errs is not None:
            all_R.extend(res.R_errs.tolist())
            all_t.extend(res.t_errs.tolist())
            # per-frame errors (frame ids follow the pooled sequence order)
            with open(os.path.join(out_dir, f"errors_{obj_name}.json"), "w") as f:
                json.dump(
                    {
                        "frames": [r.img_file for r in records],
                        "R_errs_deg": np.asarray(res.R_errs).tolist(),
                        "t_errs_cm": np.asarray(res.t_errs).tolist(),
                        "num_inliers": np.asarray(res.num_inliers).tolist(),
                        # confident matches fed to PnP
                        "num_matches": np.asarray(res.num_matches).tolist(),
                    },
                    f,
                    indent=1,
                )
        print(f"[{obj_name}] {len(ds)} frames: {res.metrics}")

    summary = aggregate_metrics(all_R, all_t, pose_thresholds=pose_thresholds)
    # per-metric means over objects (reference gathered_metrics,
    # inference.py:108-135) in the reference metrics.txt block layout
    gathered = {}
    for m in per_object.values():
        for k, v in (m or {}).items():
            gathered.setdefault(k, []).append(v)
    with open(os.path.join(out_dir, "metrics.txt"), "w") as f:
        for obj, m in per_object.items():
            f.write(f"{obj}: \n")
            for k, v in (m or {}).items():
                f.write(f"{k}: {v}  ")
            f.write("\n ---------------- \n")
        f.write("Summary: \n")
        for k, vs in gathered.items():
            f.write(f"{k}: {float(np.mean(vs))}\n")
        f.write(f"ALL: {json.dumps(summary)}\n")
    print("ALL:", summary)
    ps = profiler.summary()
    if ps:
        print(ps)
    for path in profiler.write(out_dir):
        print(f"profile -> {path}")


def main(argv=None) -> None:
    cfg = load_config(str(CONFIGS_DIR), sys.argv[1:] if argv is None else argv)
    if cfg.get("type") != "inference":
        raise SystemExit("usage: python -m onepose_plus_plus_tpu_torch.inference "
                         "+experiment=<inference config> [overrides]")
    inference(cfg)
