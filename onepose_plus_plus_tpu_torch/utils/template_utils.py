"""Run-setup helpers: config pretty-printing and hyperparameter logging (a copy
of ``onepose_plus_plus_tpu/utils/template_utils.py``, which the port may not
import).

Behavioral port of reference ``src/utils/template_utils.py`` (154 LoC: rich
config tree print, hparam broadcast to loggers, wandb finish).
"""
from __future__ import annotations

from typing import Any, Dict, Optional


def format_config(cfg: Dict[str, Any], indent: int = 0) -> str:
    """Render a nested config dict as an indented tree (rich-print stand-in)."""
    lines = []
    pad = "  " * indent
    for k in sorted(cfg.keys()) if isinstance(cfg, dict) else []:
        v = cfg[k]
        if isinstance(v, dict):
            lines.append(f"{pad}{k}:")
            lines.append(format_config(v, indent + 1))
        else:
            lines.append(f"{pad}{k}: {v}")
    return "\n".join(l for l in lines if l)


def print_config(cfg: Dict[str, Any]) -> None:
    print("=" * 60)
    print(format_config(dict(cfg)))
    print("=" * 60)


def flatten_config(cfg: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Flatten nested config to dotted keys (for TB hparams logging)."""
    out: Dict[str, Any] = {}
    for k, v in cfg.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_config(v, key))
        elif isinstance(v, (int, float, str, bool)) or v is None:
            out[key] = v
        else:
            out[key] = str(v)
    return out


def log_hparams(cfg: Dict[str, Any], writer: Optional[Any] = None) -> None:
    """Log flattened hyperparameters to a TensorBoard writer (if any)."""
    flat = flatten_config(dict(cfg))
    if writer is not None:
        try:
            writer.add_hparams(
                {k: v for k, v in flat.items() if isinstance(v, (int, float, str, bool))},
                {},
            )
        except Exception:
            for k, v in flat.items():
                writer.add_text(f"hparams/{k}", str(v))
