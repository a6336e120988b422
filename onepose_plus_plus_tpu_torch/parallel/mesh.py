"""Data-parallel training on ``torch.distributed`` (port of
``onepose_plus_plus_tpu/parallel/mesh.py``).

The JAX package runs one program over a ``Mesh(('data',))`` with the batch
sharded on it; here each rank is one process on one device, joined by a
process group: NCCL on CUDA devices, gloo only where the device is the CPU
(no fallback from one to the other). :func:`make_mesh` joins the group,
:func:`replicate` wraps the model in ``DistributedDataParallel``,
:func:`shard_batch` puts this rank's shard of a batch on its device (the
``TrainLoader`` shards the samples by rank) and :func:`device_prefetch`
keeps batches copying ahead of the step.
"""
from __future__ import annotations

import collections
import dataclasses
import socket
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from . import comm


@dataclasses.dataclass(frozen=True)
class Mesh:
    rank: int
    world: int
    device: torch.device
    backend: str


def free_port() -> int:
    """A TCP port on localhost that is free now (for the rendezvous)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_mesh(device: str = "cuda", rank: int = 0, world_size: int = 1,
              init_method: Optional[str] = None) -> Mesh:
    """Join the data-parallel process group as ``rank`` of ``world_size``.

    ``device`` ``cuda``: NCCL, rank r on GPU r (NCCL refuses two ranks on one
    GPU); ``cpu``: gloo. ``init_method`` (``tcp://localhost:<port>``) names
    the rendezvous; a world of one makes its own. Batch reductions get a
    process group of their own (``comm.set_batch_group``).
    """
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("trainer.device=cuda but no CUDA device is visible")
        if world_size > torch.cuda.device_count():
            raise ValueError(f"{world_size} ranks but {torch.cuda.device_count()} GPUs: "
                             "NCCL takes one rank a GPU")
        dev, backend = torch.device("cuda", rank), "nccl"
        torch.cuda.set_device(dev)
    elif device == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"unknown device {device!r}")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"a {dist.get_backend()} process group exists; {device} needs {backend}")
    else:
        if init_method is None:
            if world_size != 1:
                raise ValueError("init_method is required for more than one rank")
            init_method = f"tcp://localhost:{free_port()}"
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)
    comm.set_batch_group(dist.new_group(backend=backend) if world_size > 1 else None)
    return Mesh(rank=rank, world=world_size, device=dev, backend=backend)


def release_mesh() -> None:
    """Leave the process group (the end of training)."""
    comm.set_batch_group(None)
    if dist.is_initialized():
        dist.destroy_process_group()


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.parallel.DistributedDataParallel:
    """The module under DDP: rank 0's parameters and buffers are broadcast
    once, gradients are averaged over ranks at each synchronised backward.
    Buffers are not broadcast per step (BatchNorm's statistics are already
    the global batch's on every rank), and parameters that a forward leaves
    unused (the fine stage's q/k at a length-1 source) are allowed."""
    return torch.nn.parallel.DistributedDataParallel(
        module, device_ids=[mesh.device] if mesh.device.type == "cuda" else None,
        broadcast_buffers=False, find_unused_parameters=True,
    )


class DeviceBatch(dict):
    """A batch of device tensors whose host-to-device copies may still run
    on a side stream; :meth:`ready` makes the current stream wait for them."""

    event: Optional[torch.cuda.Event] = None

    def ready(self) -> "DeviceBatch":
        if self.event is not None:
            stream = torch.cuda.current_stream()
            stream.wait_event(self.event)
            for t in self.values():
                t.record_stream(stream)  # allocated on the side stream, used on this one
            self.event = None
        return self


_COPY_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def shard_batch(batch: Dict[str, np.ndarray], mesh: Mesh) -> DeviceBatch:
    """This rank's shard of a host batch (numpy arrays, as the rank's
    ``TrainLoader`` yields it) on the rank's device. On a GPU each array is
    pinned and copied on a side stream; the batch is ready after
    :meth:`DeviceBatch.ready`."""
    if mesh.device.type != "cuda":
        return DeviceBatch({k: torch.from_numpy(v) for k, v in batch.items()})
    stream = _COPY_STREAMS.setdefault(mesh.device, torch.cuda.Stream(mesh.device))
    pinned = {k: torch.from_numpy(v).pin_memory() for k, v in batch.items()}
    with torch.cuda.stream(stream):
        out = DeviceBatch({k: v.to(mesh.device, non_blocking=True) for k, v in pinned.items()})
        out.event = torch.cuda.Event()
        out.event.record(stream)
    return out


def device_prefetch(iterator, put, depth: int = 2) -> Iterator[Any]:
    """Keep ``depth`` batches put ahead of the consumer, so their copies
    overlap the previous step; a batch is :meth:`DeviceBatch.ready` when it
    is yielded."""
    buf = collections.deque()
    for item in iterator:
        buf.append(put(item))
        if len(buf) >= depth:
            yield _ready(buf.popleft())
    while buf:
        yield _ready(buf.popleft())


def _ready(batch):
    return batch.ready() if isinstance(batch, DeviceBatch) else batch


def all_gather_metrics(metrics: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Every rank's metric arrays, concatenated along axis 0 in rank order
    (identity in a single process)."""
    if comm.world_size() == 1:
        return metrics
    gathered = comm.all_gather_objects({k: np.asarray(v) for k, v in metrics.items()})
    return {k: np.concatenate([g[k] for g in gathered], axis=0) for k in metrics}
