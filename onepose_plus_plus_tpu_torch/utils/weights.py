"""Weights across the two packages.

The port's modules carry the reference's state-dict names, so
``onepose_plus_plus_tpu.utils.checkpoint.convert_torch_state_dict`` maps a
port ``state_dict()`` onto the JAX variable tree, and :func:`state_dict_from_jax`
is its inverse: flax ``{'params', 'batch_stats'}`` (numpy leaves) -> port
``state_dict``. Layouts: conv HWIO -> OIHW, linear [in, out] -> [out, in].
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}
_OUTCONV2 = {"conv1": "0", "bn": "1", "conv2": "3"}


def _walk(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _walk(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def _torch_name(path: Tuple[str, ...]) -> str:
    """Flax path (without the collection) -> reference torch parameter name."""
    parts = []
    for i, p in enumerate(path[:-1]):
        parent = path[i - 1] if i else ""
        if p == "BatchNorm_0":
            continue
        if p == "kpt_encoder":
            parts.append("kpt_3d_pos_encoding")
        elif re.fullmatch(r"layer_\d+", p):  # transformer stacks
            parts += ["layers", p.split("_")[1]]
        elif re.fullmatch(r"layer\d+_\d+", p):  # ResNet blocks
            parts += p.split("_")
        elif re.fullmatch(r"dense_\d+", p):  # keypoint MLP: Linear at 0, 3, 6, 9
            parts += ["encoder", str(3 * int(p.split("_")[1]))]
        elif re.fullmatch(r"layer\d+_outconv2", parent) and p in _OUTCONV2:
            parts.append(_OUTCONV2[p])
        elif p in ("mlp_0", "mlp_1"):
            parts += ["mlp", "0" if p == "mlp_0" else "2"]
        elif p in ("downsample_conv", "downsample_bn"):
            parts += ["downsample", "0" if p == "downsample_conv" else "1"]
        else:
            parts.append(p)
    return ".".join(parts + [_LEAF[path[-1]]])


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``{'params', 'batch_stats'}`` tree (numpy leaves) -> port state_dict."""
    out = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _walk(variables.get(collection, {})):
            arr = np.asarray(leaf)
            if path[-1] == "kernel":
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            out[_torch_name(path)] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def random_state_dict(model: torch.nn.Module, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random weights for ``model`` drawn from a numpy seed: convs He-normal
    (fan out), linears LeCun-normal, norm scales near 1, biases and BN means
    near 0, BN variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("num_batches_tracked"):
            out[name] = t.clone()
            continue
        if name.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif t.dim() == 4:
            a = rng.standard_normal(shape) * np.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
        elif t.dim() == 2:
            a = rng.standard_normal(shape) / np.sqrt(shape[1])
        elif name.endswith("weight"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = 0.1 * rng.standard_normal(shape)
        out[name] = torch.from_numpy(a.astype(np.float32))
    return out


def load_jax_variables(model: torch.nn.Module, variables: Mapping) -> None:
    """Load a JAX variable tree into a port model; every tensor must land."""
    result = model.load_state_dict(state_dict_from_jax(variables), strict=False)
    missing = [k for k in result.missing_keys if not k.endswith("num_batches_tracked")]
    if missing or result.unexpected_keys:
        raise KeyError(f"weight bridge: missing {missing}, unexpected {result.unexpected_keys}")
