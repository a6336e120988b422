"""The port's training CLI end to end on the CPU: one epoch on a tiny synthetic
capture (the one ``tests/test_cli_train_and_parsers.py`` builds for the JAX
CLI), its loss log, TensorBoard scalars, checkpoints and validation, then a
resumed second epoch. Also checks that the CLI process never loads JAX."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from synthetic_scenes import make_scene

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _capture(tmp_path):
    from onepose_plus_plus_tpu.data.preprocessing import save_3d_annotation

    rng = np.random.default_rng(0)
    n_pts, img = 40, 64
    K, pts, Ts = make_scene(rng, n_views=8, n_pts=n_pts, img=float(img))
    d = tmp_path / "obj"
    (d / "color").mkdir(parents=True)
    anno_p = str(d / "anno_3d_average.npz")
    save_3d_annotation(anno_p, pts.astype(np.float32), rng.standard_normal((n_pts, 128)).astype(np.float32),
                       np.ones(n_pts, np.float32))
    save_3d_annotation(str(d / "anno_3d_average_coarse.npz"), pts.astype(np.float32),
                       rng.standard_normal((n_pts, 256)).astype(np.float32), np.ones(n_pts, np.float32))
    manifest = []
    for i in range(8):
        p = str(d / "color" / f"{i}.png")
        cv2.imwrite(p, (rng.random((img, img)) * 255).astype(np.uint8))
        manifest.append({"img_file": p, "pose": Ts[i].tolist(), "K": K.tolist(), "avg_anno3d_file": anno_p,
                         "assign_pairs": np.stack([np.arange(n_pts)] * 2).tolist()})
    path = tmp_path / "train.json"
    path.write_text(json.dumps(manifest))
    return path


def _run(args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    # TensorBoard imports TensorFlow where it is installed, and TensorFlow
    # imports JAX; block it so the check below sees the port's own imports
    code = ("import runpy, sys\n"
            "sys.modules['tensorflow'] = None\n"
            "sys.argv = ['train'] + sys.argv[1:]\n"
            "runpy.run_module('onepose_plus_plus_tpu_torch.train', run_name='__main__')\n"
            "print('JAX LOADED' if 'jax' in sys.modules else 'NO JAX')\n")
    return subprocess.run([sys.executable, "-c", code, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_train_cli_runs_checkpoints_and_resumes(tmp_path):
    manifest = _capture(tmp_path)
    ckpt = tmp_path / "ckpts"
    common = [
        "+experiment=train",
        f"dataset.train_anno_file={manifest}",
        f"dataset.val_anno_file={manifest}",
        "dataset.img_resize=64",
        "dataset.shape3d_train=32",
        "dataset.image_warp_adapt=false",
        "trainer.device=cpu",
        "trainer.batch_size=2",
        "trainer.loader_workers=0",
        "trainer.log_every_n_steps=2",
        f"ckpt_dir={ckpt}",
        f"log_dir={tmp_path / 'logs'}",
        "model.loftr_coarse.layer_iter_n=1",
        "model.match_coarse.max_matches=16",
        "model.match_coarse.train_max_matches=16",
        "model.match_coarse.train_pad_num_gt_min=4",
    ]
    r = _run(common + ["trainer.epochs=1"])
    assert r.returncode == 0, r.stderr[-4000:]
    lines = r.stdout.splitlines()
    assert any(line.startswith("epoch 0 step 1 loss") for line in lines), r.stdout
    assert any(line.startswith("epoch 0 step 4 loss") for line in lines), r.stdout  # 8 frames / 2
    assert any(line.startswith("epoch 0 val:") for line in lines), r.stdout
    assert lines[-1] == "NO JAX"
    assert list((tmp_path / "logs" / "onepose_plus_train").glob("events.out.tfevents.*"))
    exp = ckpt / "onepose_plus_train"
    for name in ("epoch_0.pt", "last.pt", "last_state.pt"):
        assert (exp / name).exists(), name
    state = torch.load(exp / "last_state.pt", weights_only=True)
    assert (state["step"], state["epoch"]) == (4, 1)
    assert state["optimizer"]["param_groups"][0]["mini_step"] == 0  # grad_accum 2: 4 micro-batches
    assert state["scheduler"]["last_epoch"] == 2

    r = _run(common + ["trainer.epochs=2", "trainer.resume=true"])
    assert r.returncode == 0, r.stderr[-4000:]
    assert f"resumed from {exp / 'last_state.pt'}: epoch 1, step 4" in r.stdout
    assert "epoch 0 step" not in r.stdout and "epoch 1 step 6 loss" in r.stdout
    assert (exp / "epoch_1.pt").exists() and not (exp / "epoch_2.pt").exists()
    assert torch.load(exp / "last_state.pt", weights_only=True)["step"] == 8
