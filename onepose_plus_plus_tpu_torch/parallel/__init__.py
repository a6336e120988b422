"""Data-parallel training on ``torch.distributed`` (port of
``onepose_plus_plus_tpu/parallel``): ``mesh`` (process group, DDP, batch
placement and prefetch) and ``comm`` (gathers and global-batch reductions)."""
from .comm import all_gather_arrays, all_gather_objects, gather_metrics, is_main_process, rank, world_size
from .mesh import all_gather_metrics, device_prefetch, make_mesh, replicate, shard_batch

__all__ = [
    "make_mesh",
    "shard_batch",
    "replicate",
    "device_prefetch",
    "all_gather_metrics",
    "world_size",
    "rank",
    "is_main_process",
    "all_gather_arrays",
    "all_gather_objects",
    "gather_metrics",
]
