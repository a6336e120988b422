"""The port's evaluation CLI (``python -m onepose_plus_plus_tpu_torch.inference``),
its checkpoint loading and the bench script, on the CPU.

The CLI runs at narrow width with ``device=cpu`` on a plane-rendered object
with a synthetic annotation. The repository's ``inference.py`` (the JAX CLI)
then runs on the same object and configuration with the port's per-object
results handed to it in place of its own matcher run, so the two CLIs'
discovery, reporting and ADD(S)/proj2D paths are compared file for file: the
same files, the same ``metrics.txt``, the same per-frame JSON.
"""
import importlib.util
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import onepose_plus_plus_tpu.inference.pipeline as jax_pipeline
from onepose_plus_plus_tpu_torch import bench
from onepose_plus_plus_tpu_torch.inference import cli
from onepose_plus_plus_tpu_torch.models.onepose_plus import OnePosePlusModel
from onepose_plus_plus_tpu_torch.utils.checkpoint import load_weights, save_weights
from onepose_plus_plus_tpu_torch.utils.visualization import save_ply
from onepose_plus_plus_tpu_torch.utils.weights import random_state_dict
from port_helpers import make_plane_object, write_annotation
from test_torch_model import NARROW

pytest.importorskip("cv2")
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
NARROW_ARGS = ["model.compute_dtype=float32", "model.loftr_backbone.initial_dim=32",
               "model.loftr_backbone.block_dims=[32,48,64]", "model.keypoints_encoding.descriptor_dim=64",
               "model.loftr_coarse.d_model=64", "model.loftr_fine.d_model=32", "model.match_coarse.thr=0.0"]


def _jax_cli():
    """The repository's ``inference.py`` as a module (it is a script, not a package module)."""
    spec = importlib.util.spec_from_file_location("jax_inference_cli", REPO / "inference.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tree(root):
    """Objects with test sequences, a demo sequence, one without an annotation."""
    for obj, seqs in (("0001-cup", ["cup-1", "cup-2", "cup-demo"]), ("0002-box", ["box-1"]),
                      ("0003-can", ["can-1", "can-2"]), ("nodash", ["x-1"])):
        for s in seqs:
            d = root / "data" / obj / s
            for sub in ("color", "intrin_ba", "poses_ba"):
                (d / sub).mkdir(parents=True)
            for i in range(3):
                (d / "color" / f"{i}.png").write_bytes(b"")
                np.savetxt(d / "intrin_ba" / f"{i}.txt", np.eye(3) * (i + 1))
                if i != 1:
                    np.savetxt(d / "poses_ba" / f"{i}.txt", np.eye(4) + i)
        if obj != "0002-box":
            (root / "sfm" / obj / "anno").mkdir(parents=True)
            (root / "sfm" / obj / "anno" / "anno_3d_average.npz").write_bytes(b"")
    (root / "data" / "0001-cup" / "cup-3").mkdir()  # no color/: not a sequence


@pytest.mark.parametrize("kwargs", [
    {}, {"ids": ["0003", "0001", "0009"]}, {"exception_obj_names": ["0001-cup"]},
    {"top_k_obj": 1}, {"num_val_seq": 1},
])
def test_discovery_and_records_match_the_jax_cli(tmp_path, kwargs):
    _tree(tmp_path)
    jax_cli = _jax_cli()
    args = (str(tmp_path / "data"), str(tmp_path / "sfm"))
    got, ref = cli.discover_eval_objects(*args, **kwargs), jax_cli.discover_eval_objects(*args, **kwargs)
    assert got == ref and got
    for _, seqs, _ in got:
        for seq in seqs:
            a, b = cli.sequence_records(seq), jax_cli.sequence_records(seq)
            assert len(a) == len(b) == 3
            for ra, rb in zip(a, b):
                assert ra.img_file == rb.img_file
                np.testing.assert_array_equal(ra.K, rb.K)
                assert (ra.pose is None) == (rb.pose is None)
                if ra.pose is not None:
                    np.testing.assert_array_equal(ra.pose, rb.pose)


def test_load_weights_round_trips_and_is_strict(tmp_path):
    model = OnePosePlusModel(NARROW)
    model.load_state_dict(random_state_dict(model, seed=3))
    state = model.state_dict()

    def fresh():
        m = OnePosePlusModel(NARROW)
        m.load_state_dict(random_state_dict(m, seed=4))
        return m

    save_weights(str(tmp_path / "w.pt"), model)
    # a reference Lightning checkpoint: the matcher under "matcher.", plus
    # entries that are not weights
    torch.save({"state_dict": {f"matcher.{k}": v for k, v in state.items()}, "epoch": 3,
                "hyper_parameters": {"lr": 1e-3}}, tmp_path / "ref.ckpt")
    for name in ("w.pt", "ref.ckpt"):
        m = fresh()
        load_weights(str(tmp_path / name), m)
        for k, v in m.state_dict().items():
            assert torch.equal(v, state[k]), (name, k)
    missing = dict(state)
    missing.pop(next(iter(missing)))
    extra = dict(state, **{"extra.weight": torch.zeros(1)})
    for bad in (missing, extra):
        torch.save(bad, tmp_path / "bad.pt")
        with pytest.raises(RuntimeError):
            load_weights(str(tmp_path / "bad.pt"), fresh())


def _object(tmp_path, n_frames=6):
    obj = make_plane_object(str(tmp_path / "data"), obj="0801-toy", seq="toy-1", n_frames=n_frames, img=128)
    write_annotation(str(tmp_path / "sfm"), obj, 300, 32, 64)
    return obj


def _argv(tmp_path, out, extra=()):
    return ["+experiment=inference_onepose", "ids=null", f"dataset.data_dir={tmp_path / 'data'}",
            f"dataset.sfm_outputs_dir={tmp_path / 'sfm'}", "dataset.img_resize=128", "dataset.shape3d=200",
            "inference.num_hypotheses=64", f"output_dir={out}", *NARROW_ARGS, *extra]


def _files(d):
    return {p.name: p.read_text() for p in Path(d).iterdir()}


@pytest.mark.parametrize("add_metric", [False, True])
def test_cli_writes_what_the_jax_cli_writes(tmp_path, monkeypatch, capsys, add_metric):
    obj = _object(tmp_path)
    extra = []
    if add_metric:  # the LINEMOD path: ADD(S)-0.1d and proj2D against the CAD model
        pts = np.random.default_rng(0).uniform(-0.3, 0.3, (200, 3))
        save_ply(str(tmp_path / "cad" / f"{obj}.ply"), pts)
        extra = ["eval_metrics.eval_ADD_metric=true", f"cad.cad_models_dir={tmp_path / 'cad'}"]
    results = []

    def recorded(*args, **kwargs):
        results.append(cli_run(*args, **kwargs))
        return results[-1]

    cli_run = cli.run_inference
    monkeypatch.setattr(cli, "run_inference", recorded)
    cli.main(_argv(tmp_path, tmp_path / "port", ["device=cpu", *extra]))
    out = capsys.readouterr().out
    assert "WARNING: no onepose_weights" in out and "ALL:" in out
    res = results[0]
    assert res.poses.shape == (6, 4, 4) and np.isfinite(res.poses).all()

    # the JAX CLI on the same object, handed the port's results
    jax_cli = _jax_cli()
    monkeypatch.setattr(jax_cli, "build_onepose_model", lambda cfg: types.SimpleNamespace(
        init=lambda *a, **k: {}))
    monkeypatch.setattr(jax_pipeline, "make_query_step", lambda *a, **k: None)
    monkeypatch.setattr(jax_cli, "run_inference", lambda *a, **k: types.SimpleNamespace(**vars(res)))
    cfg = jax_cli.load_config(str(REPO / "configs"), _argv(tmp_path, tmp_path / "jax", extra))
    jax_cli.inference(cfg)
    port_files, jax_files = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert set(port_files) == set(jax_files) == {"metrics.txt", f"errors_{obj}.json"}
    assert port_files["metrics.txt"] == jax_files["metrics.txt"]
    assert ("ADD metric" in port_files["metrics.txt"]) == add_metric
    assert port_files["metrics.txt"].splitlines()[-1].startswith("ALL: {")
    errors = json.loads(port_files[f"errors_{obj}.json"])
    assert errors == json.loads(jax_files[f"errors_{obj}.json"])
    assert set(errors) == {"frames", "R_errs_deg", "t_errs_cm", "num_inliers", "num_matches"}
    assert len(errors["frames"]) == 6


def test_cli_profilers_write_their_files(tmp_path, capsys):
    _object(tmp_path, n_frames=2)
    for name, expect in (("advanced", ".pstats"), ("chrome", "profile_trace.json")):
        out = tmp_path / name
        cli.main(_argv(tmp_path, out, ["device=cpu", f"profiler_name={name}", "inference.frame_batch=2"]))
        assert any(f.endswith(expect) for f in os.listdir(out)), os.listdir(out)
    assert "Action" in capsys.readouterr().out


def _python_m(module, args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    return subprocess.run([sys.executable, "-m", module, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_entry_point(tmp_path):
    r = _python_m("onepose_plus_plus_tpu_torch.inference", ["+experiment=train.yaml"])
    assert r.returncode != 0 and "usage" in r.stderr
    r = _python_m("onepose_plus_plus_tpu_torch.inference",
                  ["+experiment=inference_onepose", f"dataset.data_dir={tmp_path}", "device=cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "no evaluable objects" in r.stdout


def test_bench_main_prints_one_record(capsys):
    record = bench.main(batch=2, img=64, n_points=300, steps=2, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == record
    assert set(record) == {"metric", "value", "unit", "vs_baseline"}
    assert record["metric"] == "query_poses_per_sec_per_chip" and record["unit"] == "poses/sec"
    assert record["value"] > 0 and record["vs_baseline"] == round(record["value"] / bench.REFERENCE_FPS, 2)
