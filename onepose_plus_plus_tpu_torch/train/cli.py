"""Training CLI: ``python -m onepose_plus_plus_tpu_torch.train +experiment=train.yaml [overrides]``.

Port of the repository's ``train_onepose_plus.py::train`` (:52-273) and
``_validate`` (:276): the reference LR rule on the world batch, fine-weight
autoscale, MultiStep schedule over optimizer updates, gradient accumulation,
TensorBoard scalars (a ``scalars.jsonl`` where TensorBoard is not installed),
the training callbacks (``callbacks.py``: the match figure with
``trainer.enable_plotting``; ``trainer.callbacks`` names the others:
``grad_stats``, ``lr``, ``checkpoint_artifacts``), per-epoch and ``last``
weight checkpoints, a full ``last_state.pt`` for resume, and per-epoch pose
validation through the port's ``run_inference``. The data pipeline
(``OnePosePlusTrainDataset``, ``TrainLoader``) is the port's own copy of the
JAX package's (``data/``).

``trainer.device`` (default ``cuda``) names the device type and
``trainer.n_devices`` the number of data-parallel ranks: -1 is every visible
GPU (one process on the CPU), N is N. Training always runs through
``parallel``: one process a rank (spawned here for more than one),
DDP over NCCL on GPUs, over gloo on the CPU, the step over the global batch
of ``batch_size x ranks`` (``train_step.py``); only rank 0 writes
checkpoints, logs and figures. Batches are pinned and copied on a side
stream two ahead of the step (``parallel.mesh.device_prefetch``). cuDNN
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
from ..parallel.comm import gather_metrics
from ..parallel.mesh import Mesh, device_prefetch, free_port, make_mesh, release_mesh, replicate, shard_batch
from ..utils.checkpoint import restore_train_state, save_train_state, save_weights
from ..utils.config_loader import load_config as load_config_file
from ..utils.weights import random_state_dict
from .callbacks import (
    CheckpointArtifactCallback,
    GradientStatsCallback,
    LearningRateCallback,
    TrainMatchFigureCallback,
    run_callbacks_epoch,
    run_callbacks_step,
)
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
    """GT-padding sampler of one epoch, the same on every rank: a resumed run
    draws what an uninterrupted one would, and ranks draw the global batch's."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([seed, epoch + 1]).generate_state(1)[0]))
    return gen


class ScalarFileWriter:
    """The writer where TensorBoard is not installed: scalars appended to
    ``scalars.jsonl``, images saved as PNG files, in ``log_dir``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir

    def add_scalar(self, tag: str, value, step: int) -> None:
        with open(os.path.join(self.log_dir, "scalars.jsonl"), "a") as f:
            f.write(json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n")

    def add_image(self, tag: str, image: np.ndarray, step: int, dataformats: str = "HWC") -> None:
        """Write an [H, W, 3] uint8 RGB image (``SummaryWriter.add_image``'s
        arguments, HWC only) as ``<tag>_<step>.png``."""
        import cv2

        if dataformats != "HWC":
            raise ValueError(f"ScalarFileWriter.add_image takes HWC images, not {dataformats}")
        path = os.path.join(self.log_dir, f"{tag.replace('/', '_')}_{step}.png")
        cv2.imwrite(path, np.ascontiguousarray(np.asarray(image)[..., ::-1]))

    def close(self) -> None:
        pass


def _writer(log_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return ScalarFileWriter(log_dir)
    return SummaryWriter(log_dir)


def world_size_of(cfg) -> int:
    """Data-parallel ranks: ``trainer.n_devices``, -1 (or null) = every
    visible GPU on ``cuda``, one process on the CPU."""
    n = cfg.trainer.get("n_devices", -1)
    if n in (-1, None):
        return torch.cuda.device_count() if cfg.trainer.get("device", "cuda") == "cuda" else 1
    return int(n)


def train(cfg) -> None:
    """Train on ``world_size_of(cfg)`` ranks: this process alone for one
    rank, else one spawned process a rank joined over ``tcp://localhost``."""
    device = cfg.trainer.get("device", "cuda")
    if device not in ("cuda", "cpu"):
        raise SystemExit(f"trainer.device={device}: cuda or cpu")
    world = world_size_of(cfg)
    if world < 1:
        raise SystemExit("trainer.device=cuda but no CUDA device is visible")
    if world == 1:
        return train_rank(0, 1, cfg, None)
    torch.multiprocessing.start_processes(train_rank, args=(world, cfg, f"tcp://localhost:{free_port()}"),
                                          nprocs=world, start_method="spawn")


def train_rank(rank: int, world: int, cfg, init_method) -> None:
    """One rank's training: join the process group, train, leave it."""
    device = cfg.trainer.get("device", "cuda")
    if device == "cpu" and world > 1:  # ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mesh = make_mesh(device, rank, world, init_method)
    try:
        _train(cfg, mesh)
    finally:
        release_mesh()


def _train(cfg, mesh: Mesh) -> None:
    main = mesh.rank == 0
    say = print if main else (lambda *a, **k: None)
    np.random.seed(cfg.seed)
    device = mesh.device
    # every micro-batch has the same shapes: let cuDNN time its convolution
    # algorithms once, as XLA autotunes the JAX package's (untimed, cuDNN's
    # f32 choice for the backbone's backward was an FFT path that took most of
    # a micro-batch on an NVIDIA H100 80GB HBM3, 700.00 W)
    torch.backends.cudnn.benchmark = True
    batch_size = cfg.trainer.batch_size  # per rank
    world_bs = batch_size * mesh.world
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
    base_lr = train_cfg.true_lr(world_bs * grad_accum)
    say(f"device={device.type} ranks={mesh.world} ({mesh.backend}) world_bs={world_bs} "
        f"grad_accum={grad_accum} true_lr={base_lr:.2e}")

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
        raise SystemExit(f"dataset has {len(dataset)} samples but the world batch is {world_bs} "
                         "(batch_size x ranks): drop_last would yield zero steps")
    loader = TrainLoader(dataset, batch_size=batch_size, seed=cfg.seed,
                         num_workers=int(cfg.trainer.get("loader_workers", 4)),
                         prefetch=int(cfg.trainer.get("loader_prefetch", 2)),
                         rank=mesh.rank, world=mesh.world)
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
            say(f"resumed from {path}: epoch {start_epoch}, step {global_step}")
        else:
            say(f"resume requested but {path} not found: training from scratch", flush=True)
    ddp = replicate(model, mesh)

    log_every = int(cfg.trainer.get("log_every_n_steps", 50))
    writer, callbacks, fig_cb, grad_cb = None, [], None, None
    if main:
        writer = _writer(os.path.join(cfg.log_dir, cfg.exp_name))
        if cfg.trainer.get("enable_plotting"):
            fig_cb = TrainMatchFigureCallback(model, every=log_every)
            callbacks.append(fig_cb)
        for name in cfg.trainer.get("callbacks") or []:
            if name == "grad_stats":
                grad_cb = GradientStatsCallback(every=log_every)
                callbacks.append(grad_cb)
            elif name == "lr":
                callbacks.append(LearningRateCallback(lambda step: optimizer.param_groups[0]["lr"],
                                                      every=log_every))
            elif name == "checkpoint_artifacts":
                callbacks.append(CheckpointArtifactCallback(ckpt_dir, os.path.join(ckpt_dir, "artifacts")))
            else:
                raise SystemExit(f"trainer.callbacks: unknown callback {name!r}")

    def put(np_batch):
        return shard_batch({k: v for k, v in np_batch.items() if k in BATCH_KEYS}, mesh)

    for epoch in range(start_epoch, cfg.trainer.epochs):
        t0 = time.time()
        t_log, step_log = time.perf_counter(), global_step
        gen = _epoch_generator(device, cfg.seed, epoch)
        for batch in device_prefetch(loader.epoch(epoch), put):
            scalars = train_step(ddp, optimizer, batch, gen, train_cfg, scheduler,
                                 on_update=grad_cb.set_grads if grad_cb else None)
            global_step += 1
            if main and (global_step % log_every == 0 or global_step == 1):
                values = {k: float(v) for k, v in scalars.items()}  # synchronises
                now = time.perf_counter()
                per_step = 1e3 * (now - t_log) / max(global_step - step_log, 1)
                print(f"epoch {epoch} step {global_step} loss {values['loss']:.4f} "
                      f"({time.time() - t0:.1f}s, {per_step:.2f} ms/micro-batch)", flush=True)
                for k, v in values.items():
                    writer.add_scalar(f"train/{k}", v, global_step)
                if fig_cb is not None:
                    fig_cb.set_batch(batch, model)
                run_callbacks_step(callbacks, global_step, values, writer)
                t_log, step_log = time.perf_counter(), global_step
        if main:
            # per-epoch checkpoint (reference save_top_k=-1 + last), then the full state
            save_weights(os.path.join(ckpt_dir, f"epoch_{epoch}.pt"), model)
            save_weights(os.path.join(ckpt_dir, "last.pt"), model)
            save_train_state(os.path.join(ckpt_dir, "last_state.pt"), model, optimizer, scheduler,
                             global_step, epoch + 1)
            run_callbacks_epoch(callbacks, epoch, model, writer)
        val_file = cfg.get_path("dataset.val_anno_file")
        if val_file and os.path.exists(str(val_file)):
            val_metrics = _validate(model, load_records(str(val_file)), cfg, mesh)
            say(f"epoch {epoch} val: {val_metrics}")
            if writer and val_metrics:
                for k, v in val_metrics.items():
                    writer.add_scalar(f"val/{k}", float(v), global_step)
        say(f"epoch {epoch} done in {time.time() - t0:.1f}s -> {ckpt_dir}", flush=True)
    if writer:
        writer.close()


def _validate(model, records, cfg, mesh: Mesh, max_frames: int = 64):
    """Pose errors of the first ``max_frames`` validation frames through the
    batched match + PnP pipeline, the frames dealt over the ranks and the
    errors gathered (``gather_metrics``); frames share their object's
    annotation."""
    by_anno = {}
    for r in records[:max_frames][mesh.rank::mesh.world]:
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
    gathered = gather_metrics({"R": all_R, "t": all_t})
    R = sum((g["R"] for g in gathered), [])
    t = sum((g["t"] for g in gathered), [])
    return aggregate_metrics(R, t) if R else {}


def main(argv=None) -> None:
    cfg = load_config(sys.argv[1:] if argv is None else argv)
    if cfg.get("type") != "train":
        raise SystemExit("usage: python -m onepose_plus_plus_tpu_torch.train "
                         "+experiment=train.yaml [overrides]")
    train(cfg)
