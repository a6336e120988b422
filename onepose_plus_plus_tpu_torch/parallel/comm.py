"""Cross-process communication on ``torch.distributed`` (port of
``onepose_plus_plus_tpu/parallel/comm.py``; reference ``src/utils/comm.py:84-215``).

Object gathers for validation metrics, and the global-batch reductions of
data-parallel training. The JAX package trains one program over a batch
sharded on a device mesh, so every reduction over the batch there is a
reduction over the global batch. Under DDP each rank holds a shard, and
inside :func:`global_batch` the reductions that span the batch (BatchNorm
statistics, the losses' normalising counts, the GT-padding draws, the 3D
keypoints' scale from the batch's first sample) span every rank's shard
through :func:`batch_sum`, :func:`batch_max`, :func:`batch_shard` and
:func:`batch_first_shard`. Outside it, or in a single process, they are the
identity: nothing changes there.
"""
from __future__ import annotations

import contextlib
import pickle
from typing import Any, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

_BATCH_GROUP = None  # process group of the global-batch reductions (set by mesh.make_mesh)
_IN_GLOBAL_BATCH = False


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def rank() -> int:
    return dist.get_rank() if _initialized() else 0


def is_main_process() -> bool:
    return rank() == 0


def all_gather_objects(obj: Any, max_bytes: int = 1 << 24) -> List[Any]:
    """Every rank's picklable object, in rank order (the reference's gloo
    gather of per-rank metric dicts). A single process returns [obj]."""
    if world_size() == 1:
        return [obj]
    n = len(pickle.dumps(obj))
    if n + 8 > max_bytes:
        raise ValueError(f"object too large to gather ({n} bytes)")
    out: List[Any] = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def all_gather_arrays(x) -> np.ndarray:
    """All-gather an array across ranks: a leading rank dimension is added
    (x[None] in a single process)."""
    return np.stack([np.asarray(a) for a in all_gather_objects(np.asarray(x))])


def gather_metrics(per_rank_metrics: dict) -> List[dict]:
    """Every rank's metric dict (the reference's validation-epoch gather)."""
    return all_gather_objects(per_rank_metrics)


def set_batch_group(group) -> None:
    """The process group of the global-batch reductions: one of its own, so
    that they never interleave with DDP's gradient all-reduces."""
    global _BATCH_GROUP
    _BATCH_GROUP = group


@contextlib.contextmanager
def global_batch():
    """Make the batch reductions inside span every rank's shard, as one
    process on the concatenated batch would compute them."""
    global _IN_GLOBAL_BATCH
    prev, _IN_GLOBAL_BATCH = _IN_GLOBAL_BATCH, world_size() > 1
    try:
        yield
    finally:
        _IN_GLOBAL_BATCH = prev


def batch_shard() -> Tuple[int, int]:
    """(this rank's index, number of shards) of the global batch: (0, 1)
    outside :func:`global_batch`."""
    return (rank(), world_size()) if _IN_GLOBAL_BATCH else (0, 1)


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks whose backward is the sum over ranks of the incoming
    gradients: every rank then holds the gradient of the summed objective."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of a per-shard partial over the global batch (differentiable);
    the identity outside :func:`global_batch`."""
    if not _IN_GLOBAL_BATCH:
        return x
    if x.requires_grad:
        return _AllReduceSum.apply(x, _BATCH_GROUP)
    y = x.clone()
    dist.all_reduce(y, group=_BATCH_GROUP)
    return y


def _pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 in a fixed pairwise order: ((x0 + x1) + (x2 + x3)) ..."""
    while x.shape[0] > 1:
        n = x.shape[0]
        pairs = x[0:n - 1:2] + x[1:n:2]
        x = torch.cat([pairs, x[n - 1:]]) if n % 2 else pairs
    return x[0]


def batch_sum_samples(x: torch.Tensor) -> torch.Tensor:
    """Sum over the global batch of per-sample partials x [N, ...] (dim 0 are
    this shard's samples): a fixed pairwise order over the samples, then the
    sum over ranks. Ranks holding equal power-of-two shards then add in the
    order one process adds the whole batch, to the bit (differentiable)."""
    return batch_sum(_pairwise_sum(x))


def batch_first_shard(x: torch.Tensor) -> torch.Tensor:
    """Rank 0's value of a per-shard tensor, on every rank (a quantity the
    model takes from the batch's first sample; not differentiable)."""
    if not _IN_GLOBAL_BATCH:
        return x
    y = x.detach().clone()
    dist.broadcast(y, src=0, group=_BATCH_GROUP)
    return y


def batch_max(x: torch.Tensor) -> torch.Tensor:
    """Maximum over the global batch of a per-shard maximum (not differentiable)."""
    if not _IN_GLOBAL_BATCH:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=_BATCH_GROUP)
    return y
