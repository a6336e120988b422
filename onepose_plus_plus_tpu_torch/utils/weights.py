"""Weights across the two packages.

The port's modules carry the reference's state-dict names, so
``onepose_plus_plus_tpu.utils.checkpoint.convert_torch_state_dict`` maps a
port ``state_dict()`` onto the JAX variable tree, and :func:`state_dict_from_jax`
is its inverse: flax ``{'params', 'batch_stats'}`` (numpy leaves) -> port
``state_dict``, for the 2D-3D matcher and the LoFTR pair matcher alike (its
``backbone``, ``loftr_coarse`` and ``loftr_fine`` trees follow the same
names). Layouts: conv HWIO -> OIHW, linear [in, out] -> [out, in].
:func:`load_jax_train_state` carries a whole JAX ``TrainState`` across:
parameters, BatchNorm statistics, Adam moments and the update count.
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
        elif re.fullmatch(r"LayerNorm_\d+", p):  # ... and its LayerNorms at 1, 4, 7
            parts += ["encoder", str(3 * int(p.split("_")[1]) + 1)]
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


def _find_opt_states(tree: Any, found: Dict[str, Any]) -> None:
    """Walk an optax state (namedtuples and tuples) for the MultiSteps and
    Adam states, by their fields."""
    fields = getattr(tree, "_fields", ())
    if "mini_step" in fields:
        found["multisteps"] = tree
        _find_opt_states(tree.inner_opt_state, found)
    elif "mu" in fields and "nu" in fields:
        found["adam"] = tree
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            _find_opt_states(t, found)


def load_jax_train_state(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    scheduler: torch.optim.lr_scheduler.LambdaLR,
    state: Any,
) -> int:
    """Carry a JAX ``TrainState`` (numpy leaves) into the port's model, AdamW
    optimizer and schedule (``train.train_step.make_optimizer``).

    Loads params and batch_stats, Adam's ``mu``/``nu`` as AdamW's
    ``exp_avg``/``exp_avg_sq`` and its update count as AdamW's ``step`` and the
    schedule's position. Raises unless the ``optax.MultiSteps`` accumulator
    (when there is one) sits at an update boundary, since an accumulated
    half-step has no place to go. Returns the micro-batch step.
    """
    load_jax_variables(model, {"params": state.params, "batch_stats": state.batch_stats})
    found: Dict[str, Any] = {}
    _find_opt_states(state.opt_state, found)
    if "adam" not in found:
        raise ValueError("no Adam state (mu, nu) in the JAX optimizer state")
    ms = found.get("multisteps")
    if ms is not None and int(np.asarray(ms.mini_step)) != 0:
        raise ValueError(
            f"the JAX MultiSteps accumulator is mid-accumulation (mini_step "
            f"{int(np.asarray(ms.mini_step))}); carry a state at an update boundary"
        )
    adam = found["adam"]
    count = int(np.asarray(adam.count))
    mu = state_dict_from_jax({"params": adam.mu})
    nu = state_dict_from_jax({"params": adam.nu})
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": mu[name].to(p.device, p.dtype).clone(),
            "exp_avg_sq": nu[name].to(p.device, p.dtype).clone(),
        }
        p.grad = None
    optimizer.param_groups[0]["mini_step"] = 0
    scheduler.last_epoch = count
    lrs = [base * fn(count) for base, fn in zip(scheduler.base_lrs, scheduler.lr_lambdas)]
    for group, lr in zip(optimizer.param_groups, lrs):
        group["lr"] = lr
    scheduler._last_lr = lrs
    return int(np.asarray(state.step))
