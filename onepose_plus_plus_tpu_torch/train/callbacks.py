"""Training callbacks: gradient statistics, checkpoint artifacts, the match
figure and the learning rate (port of ``onepose_plus_plus_tpu/train/callbacks.py``;
reference ``src/callbacks/wandb_callbacks.py`` and the figures of
``OnePosePlus_lightning_model.py:73-79``), logged to a TensorBoard
``SummaryWriter`` or the CLI's ``ScalarFileWriter``. The figure is drawn with
cv2 (``utils/plotting.py``) and logged as an image.
"""
from __future__ import annotations

import os
import shutil
from typing import Any, Callable, Dict, List, Optional

import torch


class Callback:
    def on_epoch_end(self, epoch: int, model, writer=None) -> None: ...

    def on_step(self, step: int, scalars: Dict[str, Any], writer=None) -> None: ...


class GradientStatsCallback(Callback):
    """Log the global gradient norm (the 'watch model' equivalent). The train
    step hands it each update's averaged gradients (``train_step``'s
    ``on_update``), before the optimizer clears them."""

    def __init__(self, every: int = 100):
        self.every = every
        self._norm: Optional[torch.Tensor] = None

    def set_grads(self, grads: List[torch.Tensor]) -> None:
        # the norm is kept on the device; reading it in on_step synchronises
        self._norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads if g is not None]))

    def on_step(self, step, scalars, writer=None):
        if writer is None or step % self.every or self._norm is None:
            return
        writer.add_scalar("train/grad_global_norm", float(self._norm), step)


class CheckpointArtifactCallback(Callback):
    """At each epoch's end, copy the ``last`` checkpoint's files (``last.pt``,
    ``last_state.pt``) into ``artifact_dir/epoch_<n>``, keeping the newest
    ``keep_last`` (the 'upload ckpt as artifact' equivalent, on the
    filesystem)."""

    FILES = ("last.pt", "last_state.pt")

    def __init__(self, ckpt_dir: str, artifact_dir: str, keep_last: int = 3):
        self.ckpt_dir = ckpt_dir
        self.artifact_dir = artifact_dir
        self.keep_last = keep_last

    def on_epoch_end(self, epoch, model, writer=None):
        srcs = [os.path.join(self.ckpt_dir, f) for f in self.FILES]
        srcs = [p for p in srcs if os.path.exists(p)]
        if not srcs:
            return
        dst = os.path.join(self.artifact_dir, f"epoch_{epoch}")
        if os.path.exists(dst):
            shutil.rmtree(dst)
        os.makedirs(dst)
        for p in srcs:
            shutil.copy2(p, dst)
        existing = sorted((d for d in os.listdir(self.artifact_dir) if d.startswith("epoch_")),
                          key=lambda d: int(d.split("_")[1]))
        for d in existing[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.artifact_dir, d))


class TrainMatchFigureCallback(Callback):
    """Reprojection figures from the live training batch (reference
    ``training_step`` with ``trainer.enable_plotting``).

    A train-mode forward on sample 0 of the current batch, as the JAX
    callback's (the plotted set includes the GT-padded slots, so early
    figures are not empty), its GT padding drawn from a generator seeded 0;
    predicted fine matches are plotted against their GT fine coordinates.
    The forward must not train: the JAX callback discards the BatchNorm
    statistics its forward updates, and here every buffer is restored bit
    for bit after it. It runs on this process alone (no global-batch
    reduction) and without autograd.
    """

    def __init__(self, model, every: int = 70, tag: str = "train_match/reprojection"):
        self.model = model
        self.every = every
        self.tag = tag
        self._batch = None

    def set_batch(self, batch: Dict[str, torch.Tensor], model=None) -> None:
        """Record the current device batch (and the model, when it changed)."""
        self._batch = batch
        if model is not None:
            self.model = model

    def forward(self):
        """(mkpts_query_f, i_ids, mconf, match_mask) of sample 0, and that sample."""
        batch1 = {k: v[:1] for k, v in self._batch.items()}
        device = next(iter(batch1.values())).device
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        buffers = [(b, b.clone()) for b in self.model.buffers()]
        was_training = self.model.training
        try:
            self.model.train()
            with torch.no_grad():
                out = self.model(batch1, generator=gen)
        finally:
            for b, saved in buffers:
                b.copy_(saved)
            self.model.train(was_training)
        return (out["mkpts_query_f"][0], out["i_ids"][0], out["mconf"][0], out["match_mask"][0]), batch1

    def make_figure(self, step: int):
        """The reprojection figure as [H, W, 3] uint8 RGB, or None when no
        slot has a supervised GT projection."""
        (mkpts_f, i_ids, _, mask), batch1 = self.forward()
        from ..utils.plotting import plot_reprojection_comparison

        mkpts_f, i_ids = mkpts_f.float().cpu().numpy(), i_ids.long().cpu().numpy()
        mask = mask.cpu().numpy()
        gt = batch1["gt_fine_xy"][0].float().cpu().numpy()[i_ids]
        # a valid slot with a supervised GT projection (-50 sentinel = none)
        keep = mask.astype(bool) & (gt[:, 0] > -40.0)
        if not keep.any():
            return None
        image = batch1["query_image"][0].float().cpu().numpy()
        return plot_reprojection_comparison(image, mkpts_f[keep], gt[keep], title=f"step {step}")

    def on_step(self, step, scalars, writer=None):
        if writer is None or step % self.every or self._batch is None:
            return
        try:
            image = self.make_figure(step)
        except Exception as e:  # plotting must never kill a training run
            import warnings

            warnings.warn(f"train figure failed at step {step}: {e!r}")
            return
        if image is not None:
            writer.add_image(self.tag, image, step, dataformats="HWC")


class LearningRateCallback(Callback):
    """Log the learning rate (reference LearningRateMonitor): ``schedule(step)``."""

    def __init__(self, schedule: Callable[[int], float], every: int = 50):
        self.schedule = schedule
        self.every = every

    def on_step(self, step, scalars, writer=None):
        if writer is None or step % self.every:
            return
        writer.add_scalar("train/lr", float(self.schedule(step)), step)


def run_callbacks_step(callbacks: List[Callback], step: int, scalars: Dict[str, Any], writer=None) -> None:
    for cb in callbacks:
        cb.on_step(step, scalars, writer)


def run_callbacks_epoch(callbacks: List[Callback], epoch: int, model, writer=None) -> None:
    for cb in callbacks:
        cb.on_epoch_end(epoch, model, writer)
