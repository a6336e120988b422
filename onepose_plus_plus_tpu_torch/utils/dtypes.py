"""Compute-dtype names of the shared configs as torch dtypes."""
from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """``compute_dtype`` string -> torch dtype (float32 for unknown names, as
    the JAX package's ``getattr(jnp, name, jnp.float32)``)."""
    return _DTYPES.get(name, torch.float32)
