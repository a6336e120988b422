"""Training CLI: ``python -m onepose_plus_plus_tpu_torch.train +experiment=train.yaml [overrides]``.

Port of the repository's ``train_onepose_plus.py::train`` (:52-273) and
``_validate`` (:276) on one device: the reference LR rule, fine-weight
autoscale, MultiStep schedule over optimizer updates, gradient accumulation,
TensorBoard scalars when TensorBoard is installed, per-epoch and ``last``
weight checkpoints, a full ``last_state.pt`` for resume, and per-epoch pose
validation through the port's ``run_inference``. The data pipeline
(``OnePosePlusTrainDataset``, ``TrainLoader``) is the port's own copy of the
JAX package's (``data/``). ``trainer.device`` (default ``cuda``) names the device;
``trainer.n_devices`` above 1 (data parallelism) is not ported yet. cuDNN
autotunes its convolutions (``cudnn.benchmark``), since every micro-batch has
the train config's fixed shapes.
"""
from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..data.augment import build_augmentor
from ..data.dataset import (
    OnePosePlusInferenceDataset,
    OnePosePlusTrainDataset,
    TrainLoader,
    load_manifest,
    records_from_coco,
)
from ..eval.metrics import aggregate_metrics
from ..inference.pipeline import run_inference
from ..models.build import onepose_config_from_dict
from ..models.onepose_plus import OnePosePlusModel
from ..utils.checkpoint import restore_train_state, save_train_state, save_weights
from ..utils.config_loader import load_config as load_config_file
from ..utils.weights import random_state_dict
from .losses import LossConfig
from .train_step import TrainConfig, make_optimizer, train_step

CONFIGS_DIR = Path(__file__).resolve().parents[2] / "configs"
BATCH_KEYS = ("query_image", "keypoints3d", "descriptors3d", "descriptors3d_coarse",
              "gt_cell", "gt_fine_xy")


def load_config(argv):
    return load_config_file(str(CONFIGS_DIR), argv)


def load_records(path: str):
    with open(path) as f:
        doc = json.load(f)
    # a merged COCO json is a dict with images/annotations, a manifest a list
    if isinstance(doc, dict) and "images" in doc:
        return records_from_coco(path)
    return load_manifest(path)


def _epoch_generator(device: torch.device, seed: int, epoch: int) -> torch.Generator:
    """GT-padding sampler of one epoch: a resumed run draws what an
    uninterrupted one would."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([seed, epoch + 1]).generate_state(1)[0]))
    return gen


def train(cfg) -> None:
    np.random.seed(cfg.seed)
    n_dev = cfg.trainer.get("n_devices", -1)
    if n_dev not in (-1, None, 1):
        raise SystemExit(f"trainer.n_devices={n_dev}: data-parallel training is not ported yet")
    device = torch.device(cfg.trainer.get("device", "cuda"))
    # every micro-batch has the same shapes: let cuDNN time its convolution
    # algorithms once, as XLA autotunes the JAX package's (untimed, cuDNN's
    # f32 choice for the backbone's backward was an FFT path that took most of
    # a micro-batch on an NVIDIA H100 80GB HBM3, 700.00 W)
    torch.backends.cudnn.benchmark = True
    world_bs = cfg.trainer.batch_size
    grad_accum = int(cfg.trainer.get("grad_accum", 1))
    train_cfg = TrainConfig(
        canonical_lr=cfg.trainer.canonical_lr,
        canonical_bs=cfg.trainer.canonical_bs,
        grad_accum=grad_accum,
        weight_decay=cfg.trainer.wd,
        milestones=tuple(cfg.trainer.milestones),
        gamma=cfg.trainer.gamma,
        loss=LossConfig(
            coarse_weight=cfg.loss.coarse_weight,
            fine_weight=cfg.loss.fine_weight_base,  # autoscaled in compute_losses
            log_space=bool(cfg.loss.get("log_space", True)),
        ),
    )
    effective_bs = world_bs * grad_accum
    base_lr = train_cfg.true_lr(effective_bs)
    print(f"device={device} batch={world_bs} grad_accum={grad_accum} true_lr={base_lr:.2e}")

    records = load_records(cfg.dataset.train_anno_file)
    dataset = OnePosePlusTrainDataset(
        records,
        img_size=cfg.dataset.img_resize,
        shape3d=cfg.dataset.shape3d_train,
        image_warp_adapt=cfg.dataset.image_warp_adapt,
        image_warp_all=bool(cfg.dataset.get("image_warp_all", False)),
        augmentor=build_augmentor(cfg.dataset.augmentor, cfg.seed),
        seed=cfg.seed,
    )
    if len(dataset) < world_bs:
        raise SystemExit(f"dataset has {len(dataset)} samples but the batch is {world_bs}: "
                         "drop_last would yield zero steps")
    loader = TrainLoader(dataset, batch_size=world_bs, seed=cfg.seed,
                         num_workers=int(cfg.trainer.get("loader_workers", 4)),
                         prefetch=int(cfg.trainer.get("loader_prefetch", 2)))
    steps_per_epoch = max(1, len(dataset) // world_bs)

    model = OnePosePlusModel(onepose_config_from_dict(dict(cfg.get("model", {}) or {})))
    model.load_state_dict(random_state_dict(model, seed=cfg.seed))
    model.to(device).train()
    optimizer, scheduler = make_optimizer(model, train_cfg, base_lr, steps_per_epoch)

    ckpt_dir = os.path.join(cfg.ckpt_dir, cfg.exp_name)
    os.makedirs(ckpt_dir, exist_ok=True)
    start_epoch, global_step = 0, 0
    resume = cfg.trainer.get("resume")
    if resume:
        path = resume if isinstance(resume, str) else os.path.join(ckpt_dir, "last_state.pt")
        if isinstance(resume, str) or os.path.exists(path):
            global_step, start_epoch = restore_train_state(path, model, optimizer, scheduler)
            print(f"resumed from {path}: epoch {start_epoch}, step {global_step}")
        else:
            print(f"resume requested but {path} not found: training from scratch", flush=True)

    writer = None
    try:
        from torch.utils.tensorboard import SummaryWriter

        writer = SummaryWriter(os.path.join(cfg.log_dir, cfg.exp_name))
    except ImportError:
        pass
    if cfg.trainer.get("enable_plotting"):
        print("trainer.enable_plotting: the match-figure callback is not ported yet")
    log_every = int(cfg.trainer.get("log_every_n_steps", 50))

    for epoch in range(start_epoch, cfg.trainer.epochs):
        t0 = time.time()
        gen = _epoch_generator(device, cfg.seed, epoch)
        for np_batch in loader.epoch(epoch):
            batch = {k: torch.from_numpy(v).to(device, non_blocking=True)
                     for k, v in np_batch.items() if k in BATCH_KEYS}
            scalars = train_step(model, optimizer, batch, gen, train_cfg, scheduler)
            global_step += 1
            if global_step % log_every == 0 or global_step == 1:
                values = {k: float(v) for k, v in scalars.items()}
                print(f"epoch {epoch} step {global_step} loss {values['loss']:.4f} "
                      f"({time.time() - t0:.1f}s)", flush=True)
                if writer:
                    for k, v in values.items():
                        writer.add_scalar(f"train/{k}", v, global_step)
        # per-epoch checkpoint (reference save_top_k=-1 + last), then the full state
        save_weights(os.path.join(ckpt_dir, f"epoch_{epoch}.pt"), model)
        save_weights(os.path.join(ckpt_dir, "last.pt"), model)
        save_train_state(os.path.join(ckpt_dir, "last_state.pt"), model, optimizer, scheduler,
                         global_step, epoch + 1)
        val_file = cfg.get_path("dataset.val_anno_file")
        if val_file and os.path.exists(str(val_file)):
            val_metrics = _validate(model, load_records(str(val_file)), cfg)
            print(f"epoch {epoch} val: {val_metrics}")
            if writer and val_metrics:
                for k, v in val_metrics.items():
                    writer.add_scalar(f"val/{k}", float(v), global_step)
        print(f"epoch {epoch} done in {time.time() - t0:.1f}s -> {ckpt_dir}", flush=True)
    if writer:
        writer.close()


def _validate(model, records, cfg, max_frames: int = 64):
    """Pose errors of the first ``max_frames`` validation frames through the
    batched match + PnP pipeline; frames share their object's annotation."""
    by_anno = {}
    for r in records[:max_frames]:
        if r.avg_anno3d_file and r.pose is not None:
            by_anno.setdefault(r.avg_anno3d_file, []).append(r)
    all_R, all_t = [], []
    model.eval()
    for anno_p, recs in by_anno.items():
        ds = OnePosePlusInferenceDataset(anno_p, recs, img_size=cfg.dataset.img_resize)
        res = run_inference(model, ds.frames(), ds.annotation, shape3d=cfg.dataset.shape3d_train,
                            frame_batch=4)
        if res.R_errs is not None:
            all_R.extend(res.R_errs.tolist())
            all_t.extend(res.t_errs.tolist())
    model.train()
    return aggregate_metrics(all_R, all_t) if all_R else {}


def main(argv=None) -> None:
    cfg = load_config(sys.argv[1:] if argv is None else argv)
    if cfg.get("type") != "train":
        raise SystemExit("usage: python -m onepose_plus_plus_tpu_torch.train "
                         "+experiment=train.yaml [overrides]")
    train(cfg)
