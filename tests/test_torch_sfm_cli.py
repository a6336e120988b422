"""The port's SfM CLI (``python -m onepose_plus_plus_tpu_torch.sfm``) on the CPU.

The entry point itself runs in a subprocess (usage error, an empty data
directory). The whole SfM of a tiny plane-rendered object runs through the
CLI's ``main`` in this process with ``device=cpu`` and float32, and with the
matcher narrowed (the full-width ``refine`` over 8 x 4096 descriptor slots
would take minutes on a CPU; chip_smoke.py phase 8 runs it at full width on
the card). It checks ``run.py``'s artifacts, that a second run reuses every
cached stage, and that stage 5 is keyed on ``anno_2d.json``, the last file it
writes.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from onepose_plus_plus_tpu_torch.config import (
    CoarseMatchingConfig,
    LoFTRConfig,
    ResNetFPNConfig,
    TransformerConfig,
)
from onepose_plus_plus_tpu_torch.models.loftr import LoFTRMatcher
from onepose_plus_plus_tpu_torch.sfm import cli
from onepose_plus_plus_tpu_torch.utils.weights import random_state_dict
from port_helpers import make_plane_object

pytest.importorskip("cv2")
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = LoFTRConfig(
    backbone=ResNetFPNConfig(initial_dim=32, block_dims=(32, 48, 64)),
    coarse=TransformerConfig(d_model=64, nhead=8, layer_iter_n=2),
    coarse_matching=CoarseMatchingConfig(thr=1e-6, temperature=0.1, border_rm=2,
                                         border_two_sided=True, max_matches=128),
    fine=TransformerConfig(d_model=32, nhead=8, layer_iter_n=1),
)


def _python_m(args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")])
    return subprocess.run([sys.executable, "-m", "onepose_plus_plus_tpu_torch.sfm", *args], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)


def test_entry_point(tmp_path):
    r = _python_m(["+experiment=train.yaml"])
    assert r.returncode != 0 and "usage" in r.stderr
    r = _python_m(["+preprocess=sfm_inference_onepose", f"dataset.data_dir={tmp_path}", "device=cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "no objects found" in r.stdout


@pytest.fixture
def narrow_matcher(monkeypatch):
    seen = []

    def build(cfg_dict, device):
        seen.append((cfg_dict, device))
        return LoFTRMatcher(NARROW).eval().to(device)

    monkeypatch.setattr(cli, "build_loftr_matcher", build)
    return seen


def _mtimes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            out[os.path.relpath(os.path.join(d, f), root)] = os.stat(os.path.join(d, f)).st_mtime_ns
    return out


def test_cli_writes_artifacts_reuses_stages_and_keys_stage5_on_anno_2d(tmp_path, narrow_matcher, capsys):
    data, out = tmp_path / "data", tmp_path / "sfm_outputs"
    obj = make_plane_object(str(data), n_frames=5, img=128)
    weights = tmp_path / "loftr.pt"
    torch.save(random_state_dict(LoFTRMatcher(NARROW), seed=1), weights)
    argv = ["+preprocess=sfm_inference_onepose", "ids=null", f"dataset.data_dir={data}",
            f"dataset.outputs_dir={out}", "dataset.down_ratio=1", "sfm.pair_batch=4", "sfm.covis_num=3",
            "sfm.max_epipolar_error_px=8.0", "sfm.match_gallery_num=2", "model.compute_dtype=float32",
            "device=cpu"]
    cli.main(argv)
    assert "random-weight matcher" in capsys.readouterr().out
    assert narrow_matcher[-1] == ({"compute_dtype": "float32"}, "cpu")
    root = out / obj
    for f in ("raw_matches.pkl", "feats-loftr.h5", "matches-loftr.h5", "post_optimize.json", "stats.json",
              "model_coarse/cameras.bin", "model/points3D.bin", "model_filted_bbox/images.bin",
              "anno/anno_3d_average.npz", "anno/anno_3d_average_coarse.npz", "anno/anno_2d.json",
              "vis3d/point_cloud_pre_filter.ply", "vis3d/point_cloud_post_filter.ply"):
        assert (root / f).exists(), f
    assert len(list((root / "vis3d" / "matches").glob("*.png"))) == 2
    with np.load(root / "anno" / "anno_3d_average.npz") as z:
        assert z["descriptors3d"].shape == (32, len(z["keypoints3d"])) and len(z["keypoints3d"]) > 0

    # a second run (with port weights from a file) reuses stages 1-3 and 5
    before = _mtimes(root)
    cli.main(argv + [f"network.loftr_weights={weights}"])
    assert "random-weight matcher" not in capsys.readouterr().out
    after = _mtimes(root)
    for f in ("raw_matches.pkl", "model_coarse/points3D.bin", "model/points3D.bin",
              "anno/anno_3d_average.npz", "anno/anno_2d.json"):
        assert after[f] == before[f], f"{f} was rewritten"

    # stage 5 cut after its first file: anno_2d.json missing -> the stage runs again
    os.remove(root / "anno" / "anno_2d.json")
    cli.main(argv)
    again = _mtimes(root)
    assert (root / "anno" / "anno_2d.json").exists()
    assert again["anno/anno_3d_average.npz"] != before["anno/anno_3d_average.npz"]
    assert again["model/points3D.bin"] == before["model/points3D.bin"]
