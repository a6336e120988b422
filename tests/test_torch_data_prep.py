"""The port's data-preparation entry points against the repository's scripts:
``merge.py``, ``parse_scanned_data.py`` and ``parse_lm_real_data.py`` and
``python -m onepose_plus_plus_tpu_torch.{merge,parse_scanned_data,
parse_lm_real_data}`` on the same synthetic inputs, written by the tests
(the captures of ``tests/test_cli_train_and_parsers.py``). Outputs must be
equal: the merged JSON as a document, every written image pixel for pixel
and every text array byte for byte.
"""
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from onepose_plus_plus_tpu_torch import merge as port_merge
from onepose_plus_plus_tpu_torch import parse_lm_real_data as port_lm
from onepose_plus_plus_tpu_torch import parse_scanned_data as port_scanned
import test_cli_train_and_parsers as jax_cli_tests

cv2 = pytest.importorskip("cv2")

REPO = Path(__file__).resolve().parent.parent


def _script(name):
    """A root script of the repository, loaded as a module."""
    spec = importlib.util.spec_from_file_location(f"repo_script_{name}", REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_script_main(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [mod.__file__, *argv])
    mod.main()


def _assert_same_tree(a: Path, b: Path):
    """Same files and links; images equal pixel for pixel, other files byte
    for byte; a link's target named by its last component."""
    files_a = sorted(p.relative_to(a) for p in a.rglob("*"))
    files_b = sorted(p.relative_to(b) for p in b.rglob("*"))
    assert files_a == files_b
    n = 0
    for rel in files_a:
        pa, pb = a / rel, b / rel
        if pa.is_symlink() or pb.is_symlink():
            assert pa.is_symlink() and pb.is_symlink(), rel
            assert Path(os.readlink(pa)).name == Path(os.readlink(pb)).name, rel
        elif pa.is_file():
            if pa.suffix == ".png":
                ia, ib = cv2.imread(str(pa), cv2.IMREAD_UNCHANGED), cv2.imread(str(pb), cv2.IMREAD_UNCHANGED)
                assert ia.shape == ib.shape and np.array_equal(ia, ib), rel
            else:
                assert pa.read_bytes() == pb.read_bytes(), rel
            n += 1
    return n


def _sfm_outputs(root: Path):
    """Three objects' SfM outputs; the third lacks its 3D annotation."""
    rng = np.random.default_rng(0)
    for k, obj in enumerate(("0801-a", "0802-b", "0803-c")):
        anno = root / obj / "anno"
        anno.mkdir(parents=True)
        entries = [{"img_file": f"/data/{obj}/color/{i}.png",
                    "assign_matrix": rng.integers(0, 50, (2, 5)).tolist()} for i in range(3 + k)]
        (anno / "anno_2d.json").write_text(json.dumps(entries))
        if k < 2:
            np.savez(anno / "anno_3d_average.npz", keypoints3d=rng.standard_normal((5, 3)))


def test_merge_matches_the_script(tmp_path, monkeypatch):
    _sfm_outputs(tmp_path / "sfm")
    jax_merge = _script("merge")
    outs = {}
    for tag in ("script", "port"):
        argv = ["+preprocess=merge_anno", f"dataset.sfm_outputs_dir={tmp_path / 'sfm'}",
                f"dataset.out_train_file={tmp_path / tag / 'train.json'}",
                f"dataset.out_val_file={tmp_path / tag / 'val.json'}", "val_objects=[0802-b]"]
        if tag == "script":
            _run_script_main(jax_merge, argv, monkeypatch)
        else:
            port_merge.main(argv)
        outs[tag] = [json.loads((tmp_path / tag / f).read_text()) for f in ("train.json", "val.json")]
    assert outs["port"] == outs["script"]
    train, val = outs["port"]
    assert len(train["images"]) == 7 and len(val["images"]) == 4  # 3 + 4 frames; the val object's 4
    assert {a["object"] for a in val["annotations"]} == {"0802-b"}


def test_merge_runs_as_a_module_without_jax(tmp_path):
    _sfm_outputs(tmp_path / "sfm")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    code = ("import runpy, sys\n"
            "sys.argv = ['merge'] + sys.argv[1:]\n"
            "runpy.run_module('onepose_plus_plus_tpu_torch.merge', run_name='__main__')\n"
            "print('JAX LOADED' if 'jax' in sys.modules else 'NO JAX')\n")
    r = subprocess.run([sys.executable, "-c", code, "+preprocess=merge_anno",
                        f"dataset.sfm_outputs_dir={tmp_path / 'sfm'}",
                        f"dataset.out_train_file={tmp_path / 'train.json'}", "dataset.out_val_file=null"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.splitlines()[-1] == "NO JAX"
    assert len(json.loads((tmp_path / "train.json").read_text())["images"]) == 7


def test_parse_scanned_data_matches_the_script(tmp_path, monkeypatch):
    jax_cli_tests.TestParseScannedData()._make_capture(str(tmp_path / "script" / "seq-1"))
    shutil.copytree(tmp_path / "script", tmp_path / "port")
    _run_script_main(_script("parse_scanned_data"),
                     ["--scanned_object_path", str(tmp_path / "script"), "--hw", "64"], monkeypatch)
    port_scanned.main(["--scanned_object_path", str(tmp_path / "port"), "--hw", "64"])
    assert _assert_same_tree(tmp_path / "script", tmp_path / "port") > 20
    assert len(os.listdir(tmp_path / "port" / "seq-1" / "color")) >= 4


def _lm_input(tmp_path):
    """A BOP-layout LINEMOD object as tests/test_cli_train_and_parsers.py
    writes it, with rotated and shifted poses."""
    rng = np.random.default_rng(1)
    obj_dir = tmp_path / "lm" / "000001"
    (obj_dir / "rgb").mkdir(parents=True)
    K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1.0]])
    gt, cams = {}, {}
    for i in range(3):
        cv2.imwrite(str(obj_dir / "rgb" / f"{i:06d}.png"), (rng.random((480, 640, 3)) * 255).astype(np.uint8))
        R = np.eye(3) if i == 0 else cv2.Rodrigues(rng.normal(0, 0.2, 3))[0]
        gt[str(i)] = [{"cam_R_m2c": R.reshape(-1).tolist(), "cam_t_m2c": [10.0 * i, -5.0, 600.0 + 20 * i],
                       "obj_id": 1}]
        cams[str(i)] = {"cam_K": K.reshape(-1).tolist()}
    (obj_dir / "scene_gt.json").write_text(json.dumps(gt))
    (obj_dir / "scene_camera.json").write_text(json.dumps(cams))
    (tmp_path / "lm" / "models").mkdir()
    (tmp_path / "lm" / "models" / "models_info.txt").write_text(
        "1 diameter 102.0 min_x -37.9 min_y -38.7 min_z -45.8 size_x 75.8 size_y 77.5 size_z 91.6\n")


@pytest.mark.parametrize("extra", [[], ["--add_detector_noise", "--crop_size", "128"]],
                         ids=["gt_boxes", "detector_noise"])
def test_parse_lm_real_data_matches_the_script(tmp_path, monkeypatch, extra):
    _lm_input(tmp_path)
    for tag in ("script", "port"):
        argv = ["--data_base_dir", str(tmp_path / "lm"), "--obj_id", "1", "--assign_onepose_id", "0801",
                "--output_data_dir", str(tmp_path / tag), *extra]
        if tag == "script":
            _run_script_main(_script("parse_lm_real_data"), argv, monkeypatch)
        else:
            port_lm.main(argv)
    assert _assert_same_tree(tmp_path / "script", tmp_path / "port") == 12  # 3 frames x 4 files
