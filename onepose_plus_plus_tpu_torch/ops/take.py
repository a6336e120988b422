"""Batched row and scalar gathers (port of ``onepose_plus_plus_tpu/ops/take.py``).

The JAX package writes these as one-hot matmuls because XLA's TPU gather is a
slow row loop; here they are plain indexed gathers. Ids are clamped into range,
as the JAX package does off the TPU; every in-tree caller passes in-range ids.
"""
from __future__ import annotations

import torch


def take_rows(values: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """values [B, L, C], ids [B, K] -> [B, K, C]."""
    idx = ids.long().clamp(0, values.shape[1] - 1)
    return torch.gather(values, 1, idx[..., None].expand(-1, -1, values.shape[-1]))


def take_scalars(values: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """values [B, M], ids [B, K] -> [B, K]."""
    return torch.gather(values, 1, ids.long().clamp(0, values.shape[1] - 1))
