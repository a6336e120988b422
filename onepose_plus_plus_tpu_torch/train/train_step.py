"""Optimizer, LR schedule, gradient accumulation and the train step.

Port of ``onepose_plus_plus_tpu/train/train_step.py`` (reference
``OnePosePlus_lightning_model.py:20-166`` and ``optimizers.py:4-42``) on one
device. The optimizer is ``optax.adamw`` as the JAX package builds it:
``torch.optim.AdamW`` with betas (0.9, 0.999), eps 1e-8 and weight decay on
every parameter, norms included; optional global-norm clipping first; and
``optax.MultiSteps`` around both: micro-batch gradients are averaged with
MultiSteps' running mean and the parameters move once every ``grad_accum``
micro-batches. The schedule counts optimizer updates, not micro-batches, as
under MultiSteps: MultiStep boundaries at ``milestones * steps_per_epoch``
updates, gamma 0.5, after an optional linear warm-up. BatchNorm statistics
update at every micro-batch (in the forward).

The accumulation state is kept where a torch checkpoint already carries it:
the running mean in each parameter's ``.grad`` and the micro-batch count in
the optimizer's param group (``"mini_step"``, ``"grad_accum"``,
``"grad_clip"``). Micro-batch k (0-based) scales ``.grad`` by k / (k + 1)
and back-propagates loss / (k + 1) into it, so ``.grad`` holds the running
mean after each backward.

The model may be wrapped in ``DistributedDataParallel``
(``parallel.mesh.replicate``). The step then runs inside
``parallel.comm.global_batch``, so BatchNorm statistics, loss normalisers
and GT-padding draws are the global batch's, and each rank's loss is the
global loss; micro-batches before an update run under ``no_sync``, so DDP
averages the accumulated running mean over the ranks once per update. The
parameters then move as the JAX package's sharded step moves them.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..parallel.comm import global_batch
from ..utils.profiling import annotate
from .losses import LossConfig, compute_losses


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    canonical_lr: float = 1e-4
    canonical_bs: int = 4
    # gradient accumulation steps (reference train.yaml accumulate_grad_batches)
    grad_accum: int = 1
    weight_decay: float = 0.1
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    milestones: Tuple[int, ...] = (3, 6, 9, 12)  # epochs
    gamma: float = 0.5
    warmup_steps: int = 0
    grad_clip: Optional[float] = None
    loss: LossConfig = LossConfig()

    def true_lr(self, world_batch_size: int) -> float:
        return self.canonical_lr * world_batch_size / self.canonical_bs


ADAM_EPS = 1e-8  # optax.adamw's default


def lr_at(cfg: TrainConfig, base_lr: float, steps_per_epoch: int, count: int) -> float:
    """LR of optimizer update ``count`` (0-based): optax's piecewise-constant
    MultiStep schedule, joined after a linear warm-up from 0 when
    ``warmup_steps`` > 0."""
    if cfg.warmup_steps > 0:
        if count < cfg.warmup_steps:
            return base_lr * count / cfg.warmup_steps
        count -= cfg.warmup_steps
    lr = base_lr
    for m in cfg.milestones:
        if count >= m * steps_per_epoch:
            lr *= cfg.gamma
    return lr


def make_optimizer(
    model: torch.nn.Module, cfg: TrainConfig, base_lr: float, steps_per_epoch: int
) -> Tuple[torch.optim.AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """(optimizer, scheduler) over every parameter of ``model``."""
    opt = torch.optim.AdamW(
        model.parameters(), lr=base_lr, betas=(cfg.adam_b1, cfg.adam_b2), eps=ADAM_EPS,
        weight_decay=cfg.weight_decay,
    )
    group = opt.param_groups[0]
    group.update(mini_step=0, grad_accum=cfg.grad_accum, grad_clip=cfg.grad_clip)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: lr_at(cfg, base_lr, steps_per_epoch, count) / base_lr
    )
    return opt, sched


def _scale_running_mean(params: Sequence[torch.Tensor], n_acc: int) -> None:
    """Ready ``.grad`` for micro-batch ``n_acc``: adding g / (n_acc + 1) to
    it then gives the running mean over n_acc + 1 micro-batches."""
    for p in params:
        if n_acc == 0:
            p.grad = None
        elif p.grad is not None:
            p.grad.mul_(n_acc / (n_acc + 1))


def _finish_micro_batch(
    optimizer: torch.optim.Optimizer,
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler],
    on_update: Optional[Callable[[List[torch.Tensor]], None]] = None,
) -> bool:
    """Count the micro-batch; on every ``grad_accum``-th one clip, step,
    advance the schedule and clear. Returns whether the parameters moved."""
    group = optimizer.param_groups[0]
    params = group["params"]
    n_acc = group["mini_step"]
    if n_acc + 1 < group["grad_accum"]:
        group["mini_step"] = n_acc + 1
        return False
    with torch.no_grad():
        for p in params:  # an unused parameter's gradient is zero (optax decays it all the same)
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if on_update is not None:
            on_update([p.grad for p in params])
        clip = group["grad_clip"]
        if clip:
            norm = torch.sqrt(sum((p.grad.float() ** 2).sum() for p in params))
            # optax.clip_by_global_norm: g * clip / norm where norm >= clip
            factor = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
            for p in params:
                p.grad.mul_(factor.to(p.grad.dtype))
    optimizer.step()
    if scheduler is not None:
        scheduler.step()
    optimizer.zero_grad(set_to_none=True)
    group["mini_step"] = 0
    return True


def accumulate_and_step(
    optimizer: torch.optim.Optimizer,
    grads,
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None,
) -> bool:
    """Fold one micro-batch's given gradients (one per parameter, None =
    zero) into the running mean, and update on every ``grad_accum``-th call.
    Returns whether the parameters moved."""
    group = optimizer.param_groups[0]
    n_acc = group["mini_step"]
    _scale_running_mean(group["params"], n_acc)
    with torch.no_grad():
        for p, g in zip(group["params"], grads):
            if g is not None:
                g = g / (n_acc + 1)
                p.grad = g if p.grad is None else p.grad.add_(g)
    return _finish_micro_batch(optimizer, scheduler)


def train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator],
    cfg: TrainConfig,
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None,
    gt_pad_rows: Optional[torch.Tensor] = None,
    on_update: Optional[Callable[[List[torch.Tensor]], None]] = None,
) -> Dict[str, torch.Tensor]:
    """One micro-batch: train-mode forward, losses, gradients into the
    accumulator, and an optimizer update every ``grad_accum`` micro-batches.

    ``model`` is a ``OnePosePlusModel`` or its DDP wrapper. ``generator``
    draws the GT-padding rows (``gt_pad_rows`` injects them). ``on_update``
    sees the (averaged) gradients just before an update. Returns the scalars
    ``loss``, ``loss_c``, ``loss_f``, ``max_conf`` (the global batch's) as
    detached 0-d tensors on the model's device (reading them synchronises).
    """
    with annotate("train_step", frames=batch["query_image"].shape[0]):
        ddp = isinstance(model, torch.nn.parallel.DistributedDataParallel)
        net = model.module if ddp else model
        net.train()
        group = optimizer.param_groups[0]
        n_acc = group["mini_step"]
        with annotate("train_step.update"):  # the running mean's scaling, before the backward adds to it
            _scale_running_mean(group["params"], n_acc)
        sync = not ddp or n_acc + 1 >= group["grad_accum"]
        with (contextlib.nullcontext() if sync else model.no_sync()), global_batch():
            with annotate("train_step.forward"):
                out = model(batch, generator=generator, gt_pad_rows=gt_pad_rows)
                loss, scalars = compute_losses(out, batch, cfg.loss, net.cfg.fine.window_size)
            with annotate("train_step.backward"):
                (loss / (n_acc + 1)).backward()
        with annotate("train_step.update"):
            _finish_micro_batch(optimizer, scheduler, on_update)
        return {k: v.detach() for k, v in scalars.items()}
