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
``"grad_clip"``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..models.onepose_plus import OnePosePlusModel
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


def accumulate_and_step(
    optimizer: torch.optim.Optimizer,
    grads,
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None,
) -> bool:
    """Fold one micro-batch's gradients (one per parameter, None = zero) into
    the running mean; on every ``grad_accum``-th call clip, step, advance the
    schedule and clear. Returns whether the parameters moved."""
    group = optimizer.param_groups[0]
    params = group["params"]
    n_acc = group["mini_step"]
    with torch.no_grad():
        for p, g in zip(params, grads):
            g = torch.zeros_like(p) if g is None else g
            if n_acc == 0 or p.grad is None:
                p.grad = g.clone()
            else:
                p.grad.add_((g - p.grad) / (n_acc + 1))  # optax.MultiSteps' mean
        if n_acc + 1 < group["grad_accum"]:
            group["mini_step"] = n_acc + 1
            return False
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


def train_step(
    model: OnePosePlusModel,
    optimizer: torch.optim.Optimizer,
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator],
    cfg: TrainConfig,
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None,
    gt_pad_rows: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """One micro-batch: train-mode forward, losses, gradients into the
    accumulator, and an optimizer update every ``grad_accum`` micro-batches.

    ``generator`` draws the GT-padding rows (``gt_pad_rows`` injects them).
    Returns the scalars ``loss``, ``loss_c``, ``loss_f``, ``max_conf`` as
    detached 0-d tensors on the model's device (reading them synchronises).
    """
    model.train()
    out = model(batch, generator=generator, gt_pad_rows=gt_pad_rows)
    loss, scalars = compute_losses(out, batch, cfg.loss, model.cfg.fine.window_size)
    params = optimizer.param_groups[0]["params"]
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    accumulate_and_step(optimizer, grads, scheduler)
    return {k: v.detach() for k, v in scalars.items()}
