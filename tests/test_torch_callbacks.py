"""The port's training callbacks (``train/callbacks.py``) against the JAX
package's, and the training CLI's wiring of them on the CPU.

The figure callback runs a train-mode forward on the batch's first sample:
it must leave every buffer of the model as it was, to the bit (the JAX
callback discards the BatchNorm statistics its forward updates). Its
predicted match slots are held to the JAX callback's forward on the same
weights (the GT-padding slots draw from each package's own generator).
"""
import json
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import onepose_plus_plus_tpu.train.callbacks as jcb
from onepose_plus_plus_tpu.config import (
    CoarseMatchingConfig,
    FineConfig,
    KeypointEncodingConfig,
    OnePosePlusConfig,
    ResNetFPNConfig,
    TransformerConfig,
)
from onepose_plus_plus_tpu.models.onepose_plus import OnePosePlusModel as JaxModel
from onepose_plus_plus_tpu_torch.models.onepose_plus import OnePosePlusModel
from onepose_plus_plus_tpu_torch.train import callbacks as cb
from onepose_plus_plus_tpu_torch.utils import plotting
from onepose_plus_plus_tpu_torch.utils.weights import load_jax_variables
from port_helpers import perturbed, to_port_config
from test_torch_parallel import _global_batch
from test_torch_train_cli import REPO, _capture

torch.set_num_threads(2)

CFG = OnePosePlusConfig(
    backbone=ResNetFPNConfig(initial_dim=32, block_dims=(32, 48, 64)),
    keypoints_encoding=KeypointEncodingConfig(descriptor_dim=64),
    coarse=TransformerConfig(d_model=64, nhead=8, layer_iter_n=1),
    coarse_matching=CoarseMatchingConfig(thr=0.0, max_matches=16, train_max_matches=16, train_pad_num_gt_min=4),
    fine=FineConfig(d_model=32, transformer=TransformerConfig(d_model=32, nhead=8, layer_iter_n=1)),
)


class Writer:
    def __init__(self):
        self.scalars, self.images = [], []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))

    def add_image(self, tag, image, step, dataformats="CHW"):
        assert dataformats == "HWC" and image.dtype == np.uint8 and image.ndim == 3 and image.shape[2] == 3
        self.images.append((tag, step))


@pytest.fixture(scope="module")
def models():
    batch = _global_batch(0, n=2)
    jmodel = JaxModel(CFG)
    variables = perturbed(jax.jit(lambda k, b: jmodel.init({"params": k, "matching": k}, b, train=True))(
        jax.random.PRNGKey(0), batch))
    port = OnePosePlusModel(to_port_config(CFG))
    load_jax_variables(port, variables)
    return jmodel, variables, port.train(), batch


def test_figure_forward_matches_jax_and_leaves_buffers(models):
    """Predicted slots (all but the 4 GT-padding slots): the same mask and
    rows, fine keypoints within 1e-3 px (measured 6.9e-5) and confidences
    within 1e-4 (measured 3.1e-5; mconf agrees to ~1e-5 at the model level);
    every buffer bitwise unchanged."""
    jmodel, variables, port, batch = models
    jfig = jcb.TrainMatchFigureCallback(jmodel, every=1)
    jfig.set_batch({k: jnp.asarray(v) for k, v in batch.items()}, variables)
    (jf, ji, jc, jm), _ = jfig._forward()
    before = {n: b.clone() for n, b in port.named_buffers()}
    fig = cb.TrainMatchFigureCallback(port, every=1)
    fig.set_batch({k: torch.from_numpy(v) for k, v in batch.items()})
    (mf, mi, mc, mm), batch1 = fig.forward()
    for n, b in port.named_buffers():
        assert torch.equal(b, before[n]), n
    assert port.training
    k = CFG.coarse_matching.train_max_matches
    mask = np.asarray(jm)[:k]
    np.testing.assert_array_equal(mm.numpy()[:k], mask)
    assert mask.any()
    # the same matches (rows are unique: mutual nearest neighbours), in any slot order
    order, jorder = np.argsort(mi.numpy()[:k][mask]), np.argsort(np.asarray(ji)[:k][mask])
    np.testing.assert_array_equal(mi.numpy()[:k][mask][order], np.asarray(ji)[:k][mask][jorder])
    np.testing.assert_allclose(mf.numpy()[:k][mask][order], np.asarray(jf)[:k][mask][jorder], atol=1e-3)
    np.testing.assert_allclose(mc.numpy()[:k][mask][order], np.asarray(jc)[:k][mask][jorder], atol=1e-4)
    assert set(batch1) == set(batch) and batch1["query_image"].shape[0] == 1


def test_figure_callback_draws_and_is_seeded(models):
    _, _, port, batch = models
    fig = cb.TrainMatchFigureCallback(port, every=2)
    fig.set_batch({k: torch.from_numpy(v) for k, v in batch.items()})
    w = Writer()
    for step in (1, 2, 3, 4):
        fig.on_step(step, {}, w)
    assert w.images == [("train_match/reprojection", 2), ("train_match/reprojection", 4)]
    a, b = fig.forward()[0], fig.forward()[0]  # generator seeded 0 each time
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    fig.on_step(2, {}, None)  # no writer: nothing runs
    assert len(w.images) == 2


def test_figure_failure_warns_after_the_forward(models, monkeypatch):
    """Without matplotlib (the card's machine) the figure is drawn (cv2). A
    failure while drawing comes after the forward: the buffers stay bit for
    bit, the failure is a warning, as in the JAX callback, and the next step
    goes on."""
    _, _, port, batch = models
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    fig = cb.TrainMatchFigureCallback(port, every=1)
    fig.set_batch({k: torch.from_numpy(v) for k, v in batch.items()})
    ran = []
    forward = fig.forward
    monkeypatch.setattr(fig, "forward", lambda: ran.append(1) or forward())
    before = {n: b.clone() for n, b in port.named_buffers()}
    w = Writer()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fig.on_step(1, {}, w)
    assert ran == [1] and w.images == [("train_match/reprojection", 1)]
    assert not any("train figure failed" in str(c.message) for c in caught)

    def broken(*args, **kwargs):
        raise RuntimeError("drawing failed")

    monkeypatch.setattr(plotting, "plot_reprojection_comparison", broken)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fig.on_step(2, {}, w)
    assert ran == [1, 1] and w.images == [("train_match/reprojection", 1)]
    assert any("train figure failed at step 2" in str(c.message) and "drawing failed" in str(c.message)
               for c in caught)
    for n, b in port.named_buffers():
        assert torch.equal(b, before[n]), n
    monkeypatch.undo()
    fig.on_step(3, {}, w)  # the run goes on: the next figure is drawn
    assert w.images[-1] == ("train_match/reprojection", 3)


def test_scalar_file_writer_writes_images(tmp_path):
    """The CLI's writer without TensorBoard: ``add_image`` of an HWC uint8 RGB
    array writes ``<tag>_<step>.png`` (BGR on disk, as cv2 writes PNGs)."""
    import cv2

    from onepose_plus_plus_tpu_torch.train.cli import ScalarFileWriter

    w = ScalarFileWriter(str(tmp_path))
    image = np.zeros((6, 8, 3), np.uint8)
    image[..., 0] = 200  # red
    image[2, 3] = (1, 2, 3)
    w.add_image("train_match/reprojection", image, 7, dataformats="HWC")
    png = cv2.imread(str(tmp_path / "train_match_reprojection_7.png"))
    np.testing.assert_array_equal(png[..., ::-1], image)
    with pytest.raises(ValueError):
        w.add_image("x", image.transpose(2, 0, 1), 1, dataformats="CHW")
    assert not hasattr(w, "add_figure")


def test_gradient_stats_match_jax():
    rng = np.random.default_rng(3)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    ours, theirs = cb.GradientStatsCallback(every=5), jcb.GradientStatsCallback(every=5)
    ours.set_grads([torch.from_numpy(g) for g in grads])
    theirs.set_grads([jnp.asarray(g) for g in grads])
    w_ours, w_theirs = Writer(), Writer()
    for step in range(1, 11):
        ours.on_step(step, {}, w_ours)
        theirs.on_step(step, {}, w_theirs)
    assert [(t, s) for t, _, s in w_ours.scalars] == [(t, s) for t, _, s in w_theirs.scalars] == [
        ("train/grad_global_norm", 5), ("train/grad_global_norm", 10)]
    np.testing.assert_allclose([v for _, v, _ in w_ours.scalars], [v for _, v, _ in w_theirs.scalars], rtol=1e-6)


def test_learning_rate_callback_matches_jax():
    schedule = lambda step: 1e-3 * 0.5 ** (step // 4)  # noqa: E731
    ours, theirs = cb.LearningRateCallback(schedule, every=3), jcb.LearningRateCallback(schedule, every=3)
    w_ours, w_theirs = Writer(), Writer()
    for step in range(10):
        cb.run_callbacks_step([ours], step, {}, w_ours)
        jcb.run_callbacks_step([theirs], step, {}, w_theirs)
    assert w_ours.scalars == w_theirs.scalars and len(w_ours.scalars) == 4


def test_checkpoint_artifacts_copy_and_keep_last(tmp_path):
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    art = tmp_path / "artifacts"
    callback = cb.CheckpointArtifactCallback(str(ckpt), str(art), keep_last=2)
    cb.run_callbacks_epoch([callback], 0, None)  # nothing saved yet: nothing copied
    assert not art.exists()
    for epoch in range(4):
        (ckpt / "last.pt").write_bytes(bytes([epoch]) * 10)
        (ckpt / "last_state.pt").write_bytes(bytes([epoch]) * 20)
        cb.run_callbacks_epoch([callback], epoch, None)
    assert sorted(os.listdir(art)) == ["epoch_2", "epoch_3"]
    assert (art / "epoch_3" / "last.pt").read_bytes() == bytes([3]) * 10
    assert (art / "epoch_2" / "last_state.pt").read_bytes() == bytes([2]) * 20


def _run_cli(args, block_tensorboard=False, block_matplotlib=False):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    code = ("import runpy, sys\n"
            "sys.modules['tensorflow'] = None\n"
            + ("sys.modules['torch.utils.tensorboard'] = None\n" if block_tensorboard else "")
            + ("sys.modules['matplotlib'] = sys.modules['matplotlib.pyplot'] = None\n" if block_matplotlib else "")
            + "sys.argv = ['train'] + sys.argv[1:]\n"
            "runpy.run_module('onepose_plus_plus_tpu_torch.train', run_name='__main__')\n")
    return subprocess.run([sys.executable, "-c", code, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def _common(tmp_path, manifest):
    return ["+experiment=train", f"dataset.train_anno_file={manifest}", "dataset.img_resize=64",
            "dataset.shape3d_train=32", "dataset.image_warp_adapt=false", "trainer.device=cpu",
            "trainer.loader_workers=0", "trainer.log_every_n_steps=2", f"ckpt_dir={tmp_path / 'ckpts'}",
            f"log_dir={tmp_path / 'logs'}", "model.loftr_coarse.layer_iter_n=1",
            "model.match_coarse.max_matches=16", "model.match_coarse.train_max_matches=16",
            "model.match_coarse.train_pad_num_gt_min=4", "trainer.epochs=1"]


def test_cli_runs_every_callback_without_tensorboard(tmp_path):
    """Every callback on; without TensorBoard the CLI logs to scalars.jsonl
    and PNG figures, and without matplotlib (the card's set) it draws them."""
    manifest = _capture(tmp_path)
    r = _run_cli(_common(tmp_path, manifest) + [
        "trainer.batch_size=2", "trainer.enable_plotting=true",
        "trainer.callbacks=[grad_stats,lr,checkpoint_artifacts]"], block_tensorboard=True, block_matplotlib=True)
    assert r.returncode == 0, r.stderr[-4000:]
    logs = tmp_path / "logs" / "onepose_plus_train"
    tags = {json.loads(line)["tag"] for line in (logs / "scalars.jsonl").read_text().splitlines()}
    assert {"train/loss", "train/grad_global_norm", "train/lr"} <= tags
    assert sorted(p.name for p in logs.glob("*.png")) == ["train_match_reprojection_2.png",
                                                         "train_match_reprojection_4.png"]
    art = tmp_path / "ckpts" / "onepose_plus_train" / "artifacts" / "epoch_0"
    assert (art / "last.pt").exists() and (art / "last_state.pt").exists()
    assert "ms/micro-batch" in r.stdout


def test_cli_trains_on_two_gloo_ranks(tmp_path):
    """trainer.n_devices=2 on the CPU: two spawned ranks over gloo, one log,
    rank 0's checkpoints, the validation gathered over both ranks."""
    manifest = _capture(tmp_path)
    r = _run_cli(_common(tmp_path, manifest) + [
        "trainer.batch_size=1", "trainer.n_devices=2", f"dataset.val_anno_file={manifest}"])
    assert r.returncode == 0, r.stderr[-4000:]
    lines = r.stdout.splitlines()
    assert any(line.startswith("device=cpu ranks=2 (gloo) world_bs=2") for line in lines), r.stdout
    assert sum(line.startswith("epoch 0 step 1 loss") for line in lines) == 1
    assert any(line.startswith("epoch 0 step 4 loss") for line in lines)  # 8 frames / world batch 2
    assert sum(line.startswith("epoch 0 val:") for line in lines) == 1
    state = torch.load(tmp_path / "ckpts" / "onepose_plus_train" / "last_state.pt", weights_only=True)
    assert (state["step"], state["epoch"]) == (4, 1)
