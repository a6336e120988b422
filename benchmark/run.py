"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``: each compared number
beside its limit, which also end standard error). Without the GPUs the cell
asks for, or with JAX or the JAX package loaded once the window has closed,
it prints no result and exits non-zero.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up counts from the start of the process

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": ROOT / ".bench_cache" / "torch_extensions",
          "TRITON_CACHE_DIR": ROOT / ".bench_cache" / "triton"}


def result_line(out: dict, trace: bool, kind: str) -> dict:
    """The result line of a run's output (``harness.run_cell``), its checks last."""
    device = {"platform": "gpu", "kind": kind, "count": 1, "memory_peak_bytes": out["peak_bytes"]}
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": out["metrics"], "device": device}
    if trace:
        device.update(busy_s=out["busy_s"], window_s=out["window_s"])
        line["breakdown"] = out["breakdown"]
    line["checks"] = out["checks"]
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for k, v in CACHES.items():
        os.environ[k] = str(v)

    from benchmark import harness
    spec = harness.load_spec()
    cell, config, traffic = harness.load_cell(args.workload, spec)
    import torch
    chips = cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[bench] {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible", file=sys.stderr)
        return 2

    ctx = harness.Context(cell, config, traffic, args.seed, torch.device("cuda", 0))
    out = harness.run_cell(ctx, args.seconds, bool(args.trace), T_START, spec)
    found = harness.forbidden_modules()
    if found:
        print(f"[bench] JAX or the JAX package is loaded in the process: {found}", file=sys.stderr)
        return 3
    line = result_line(out, bool(args.trace), torch.cuda.get_device_name(0))
    for k, v in line["checks"].items():
        print(f"[check] {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
