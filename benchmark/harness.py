"""One run of one cell: set-up, the measured window, the traced window's
readings, the comparison with the plain reference, and the result line.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``,
its configuration file, its traffic file ``benchmark/workloads/<cell>.json``
(which names the module in ``benchmark/drivers`` that runs it) and a reader
``benchmark/metrics/<metric>.py`` for each per-layer metric.

A driver is a class built from a :class:`Context` with these methods:
``setup()`` (weights, inputs, the program's objects), ``warm()`` (every
shape the cell runs, once), ``unit() -> dict`` (one whole unit of work,
returning its counts, e.g. ``{"frames": 192, "objects": 1}``), ``drain()``
(wait for the device), ``shapes() -> dict`` (what the readers need),
``release()`` (free the program's state) and ``check() -> dict`` (name ->
value; those the traffic file's ``checks`` names are compared with their
limits, the others are only reported). A driver may keep ``reference_s``, the
seconds of its set-up spent in the plain reference, which ``setup_s`` leaves
out.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict

import torch

from . import trace as tr

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "onepose_plus_plus_tpu")


@dataclasses.dataclass
class Context:
    cell: Dict[str, Any]  # the workloads entry of BENCHMARK.json
    config: Dict[str, Any]  # the configuration file
    traffic: Dict[str, Any]  # benchmark/workloads/<cell>.json
    seed: int
    device: torch.device
    control: bool = False  # the program's own lower-precision path in place of the configured one


def load_spec(root: Path = ROOT) -> Dict[str, Any]:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(name: str, spec: Dict[str, Any], root: Path = ROOT):
    """(cell entry, configuration, traffic) of the cell called ``name``."""
    cells = {c["name"]: c for c in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((BENCH_DIR / "workloads" / f"{name}.json").read_text())
    return cell, config, traffic


def load_driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}").Driver


def load_reader(metric: str):
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer_metrics(spec: Dict[str, Any], cell: Dict[str, Any]):
    """The per-layer metrics this cell reports: those that list it, and those
    without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_metrics(spec, cell)}
    return [m for m in spec["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def end_to_end_metrics(spec: Dict[str, Any], cell: Dict[str, Any]):
    return [m for m in spec["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def clock(device: torch.device) -> float:
    """The host's clock once the device has finished what was launched."""
    sync(device)
    return time.perf_counter()


def window(driver, device: torch.device, seconds: float) -> Dict[str, float]:
    """Whole units until ``seconds`` have passed (none starts after), then wait
    for the device. Returns the work counts and ``elapsed_s`` from the window's
    start to the end of the last unit."""
    work: Dict[str, float] = {}
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for k, v in driver.unit().items():
            work[k] = work.get(k, 0) + v
    driver.drain()
    sync(device)
    work["elapsed_s"] = time.perf_counter() - t0
    return work


def traced_window(driver, device: torch.device, seconds: float):
    """The window under ``torch.profiler`` (events kept in memory): the device's
    activity and the runtime calls that launched it (host operators would cost
    minutes to read back at a 30 s window); profiled again, with the host's
    operators too, where the session kept no device operation."""
    cuda, cpu = torch.profiler.ProfilerActivity.CUDA, torch.profiler.ProfilerActivity.CPU
    for activities in ([cuda], [cpu, cuda], [cpu, cuda]) if device.type == "cuda" else ([cpu],):
        sync(device)
        with torch.profiler.profile(activities=activities) as prof:
            work = window(driver, device, seconds)
        ops = tr.device_ops(prof)
        del prof
        if ops or device.type != "cuda":
            return work, ops
        print("[bench] the profiler kept no device operation; profiling the window again", file=sys.stderr)
    return work, ops


def run_cell(ctx: Context, seconds: float, trace: bool, t_start: float, spec: Dict[str, Any]) -> Dict[str, Any]:
    """One run of the cell: the result line's fields."""
    driver = load_driver(ctx.traffic["driver"])(ctx)
    t_setup = clock(ctx.device)
    driver.setup()
    t_warm = clock(ctx.device)
    driver.warm()
    t_end = clock(ctx.device)
    reference_s = getattr(driver, "reference_s", 0.0)
    setup_s = t_end - t_start - reference_s
    # where set-up goes, for the next reader of a run's standard error
    print(f"[setup] start to driver {t_setup - t_start:.3f} s, setup() {t_warm - t_setup - reference_s:.3f} s "
          f"(reference {reference_s:.3f} s apart), warm() {t_end - t_warm:.3f} s", file=sys.stderr)
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    if trace:  # the profiler's events of a 30 s window take minutes to read back: trace at most trace_seconds
        work, ops = traced_window(driver, ctx.device, min(seconds, ctx.traffic["trace_seconds"]))
    else:
        work, ops = window(driver, ctx.device, seconds), None
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    shapes = driver.shapes()
    driver.release()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = driver.check()
    limits = ctx.traffic["checks"]
    check_line = {k: {"value": numbers.get(k), "limit": v} for k, v in limits.items()}
    correct = bool(limits) and all(numbers.get(k) is not None and numbers[k] <= v for k, v in limits.items())
    out: Dict[str, Any] = {"correct": correct, "attempted": int(work.get("units", 0)),
                           "failed": int(work.get("failed", 0)), "work": work, "checks": check_line,
                           "numbers": numbers, "peak_bytes": int(peak), "setup_s": setup_s}
    if trace:
        t = tr.Trace(ops=ops, window_s=work["elapsed_s"], work=work, shapes=shapes, peak_bytes=int(peak))
        metrics = {}
        for m in per_layer_metrics(spec, ctx.cell):
            value = load_reader(m["name"])(t)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out.update(metrics=metrics, busy_s=t.busy_s, window_s=t.window_s, breakdown=t.breakdown())
    else:
        metric = ctx.traffic["metric"]
        out["metrics"] = {metric: {"value": work[ctx.traffic["work"]] / work["elapsed_s"],
                                   "unit": ctx.traffic["unit"]},
                          "setup_s": {"value": setup_s, "unit": "s"}}
    return out


def forbidden_modules(names=None) -> list:
    """Modules of JAX or of the JAX package among ``names`` (default: those
    loaded in this process), compared by whole top-level names (the port's
    name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)} & set(FORBIDDEN))
