"""Lightweight Hydra-style YAML config system.

The reference drives every CLI through Hydra (``@hydra.main`` +
``+preprocess=<file>`` / ``+experiment=<file>`` group selection and dotted
overrides, ``configs/config.yaml``, SURVEY.md §5). Hydra isn't in this
environment, so this module reimplements the USER-FACING surface on PyYAML:

  * ``load_config(configs_dir, argv)`` understands
    ``+preprocess=sfm_inference.yaml``-style group selectors and
    ``a.b.c=value`` dotted overrides (values parsed as YAML scalars);
  * group files merge over ``config.yaml`` defaults;
  * the returned :class:`Config` supports attribute access, ``.get``, and
    ``cfg.type``-based dispatch exactly like the reference CLIs use.

The port's own copy of ``onepose_plus_plus_tpu/utils/config_loader.py``,
without its XLA compile-cache hook (the port runs no XLA).
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import yaml


class Config(dict):
    """dict with attribute access and recursive wrapping."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return Config(v) if isinstance(v, dict) and not isinstance(v, Config) else v

    def __setattr__(self, k, v):
        self[k] = v

    def get_path(self, dotted: str, default=None):
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node


def _deep_merge(base: Dict, over: Dict) -> Dict:
    out = dict(base)
    for k, v in over.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _set_path(cfg: Dict, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        if p not in node or not isinstance(node[p], dict):
            node[p] = {}
        node = node[p]
    node[parts[-1]] = value


_FLOAT_RE = __import__("re").compile(
    r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$"
)


def _parse_value(s: str) -> Any:
    try:
        v = yaml.safe_load(s)
    except yaml.YAMLError:
        return s
    # YAML 1.1 parses dot-less scientific notation ("1e-6") as a string;
    # Hydra/OmegaConf accept it as a float — match that CLI surface
    if isinstance(v, str) and _FLOAT_RE.match(v):
        return float(v)
    return v


def load_config(
    configs_dir: str, argv: Optional[List[str]] = None, defaults_file: str = "config.yaml"
) -> Config:
    """Resolve a config from group selectors + dotted overrides.

    argv entries:
        ``+<group>=<file>[.yaml]`` — merge ``configs_dir/<group>/<file>.yaml``;
        ``<dotted.key>=<value>``   — override a single value;
    anything else raises (matching Hydra's strictness).
    """
    argv = list(argv or [])
    cfg: Dict = {}
    root = os.path.join(configs_dir, defaults_file)
    if os.path.exists(root):
        with open(root) as f:
            cfg = yaml.safe_load(f) or {}

    overrides: List[tuple] = []
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"unrecognized argument {arg!r} (need key=value)")
        key, value = arg.split("=", 1)
        if key.startswith("+"):
            group = key[1:]
            fname = value if value.endswith((".yaml", ".yml")) else value + ".yaml"
            path = os.path.join(configs_dir, group, fname)
            if not os.path.exists(path):
                raise FileNotFoundError(path)
            with open(path) as f:
                cfg = _deep_merge(cfg, yaml.safe_load(f) or {})
        else:
            overrides.append((key, _parse_value(value)))
    for key, value in overrides:
        _set_path(cfg, key, value)
    return Config(cfg)


def save_config(cfg: Dict, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(dict(cfg), f, sort_keys=False)
