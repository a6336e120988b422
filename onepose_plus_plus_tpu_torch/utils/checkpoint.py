"""Checkpoints of the port (``torch.save``), as
``onepose_plus_plus_tpu/utils/checkpoint.py`` keeps orbax ones.

``save_weights`` is the per-epoch and ``last`` checkpoint (the model's
``state_dict``: parameters and BatchNorm statistics). ``save_train_state`` /
``restore_train_state`` are the full state for resume: model, optimizer (with
the accumulation count in its param group), the accumulated gradients,
scheduler, micro-batch step and next epoch. Writes go to a temporary file
first, so an interrupted save never leaves a partial checkpoint under the
final name. ``load_weights`` reads a ``save_weights`` file or a reference
Lightning ``.ckpt`` into a model, strictly.
"""
from __future__ import annotations

import os
from typing import Tuple

import torch


def _atomic_save(obj, path: str) -> None:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_weights(path: str, model: torch.nn.Module) -> None:
    _atomic_save(model.state_dict(), path)


def _strip_prefix(name: str) -> str:
    """Remove the reference's wrapper prefixes (its Lightning module keeps the
    matcher under ``matcher.``; ``model.`` and ``module.`` wrap it elsewhere),
    as ``onepose_plus_plus_tpu/utils/checkpoint.py::_strip_prefix`` does."""
    for p in ("model.", "matcher.", "module."):
        if name.startswith(p):
            name = name[len(p):]
    return name


def load_weights(path: str, model: torch.nn.Module) -> None:
    """Load weights into ``model`` in place, strictly: every tensor of the
    model is set and none of the file is left over (else ``RuntimeError``).

    ``path`` is a port checkpoint (``save_weights``: the model's
    ``state_dict``, read with ``weights_only``) or a reference Lightning
    ``.ckpt``, whose ``state_dict`` carries the reference's names (the port's
    own) under a wrapper prefix. A ``.ckpt`` is a full pickle: load only
    files you trust.
    """
    blob = torch.load(path, map_location="cpu", weights_only=not path.endswith(".ckpt"))
    state = blob.get("state_dict", blob)
    model.load_state_dict({_strip_prefix(k): v for k, v in state.items()}, strict=True)


def save_train_state(
    path: str,
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    scheduler: torch.optim.lr_scheduler.LRScheduler,
    step: int,
    epoch: int,
) -> None:
    """Everything a resumed run needs to continue as the uninterrupted one."""
    params = optimizer.param_groups[0]["params"]
    _atomic_save(
        {
            "model": model.state_dict(),
            "optimizer": optimizer.state_dict(),
            "acc_grads": [None if p.grad is None else p.grad.detach().cpu() for p in params],
            "scheduler": scheduler.state_dict(),
            "step": int(step),
            "epoch": int(epoch),
        },
        path,
    )


def restore_train_state(
    path: str,
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    scheduler: torch.optim.lr_scheduler.LRScheduler,
) -> Tuple[int, int]:
    """Load a ``save_train_state`` checkpoint in place; returns (step, next epoch)."""
    tree = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(tree["model"])
    optimizer.load_state_dict(tree["optimizer"])
    for p, g in zip(optimizer.param_groups[0]["params"], tree["acc_grads"]):
        p.grad = None if g is None else g.to(p.device)
    scheduler.load_state_dict(tree["scheduler"])
    return tree["step"], tree["epoch"]
