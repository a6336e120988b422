#!/usr/bin/env python3
"""The span clock against torch.profiler's device timestamps, and spans off
outside a session, on one CUDA GPU.

    python3 scripts/torch_span_clock.py [--probes 100] [--spans 10000] [--cells query_eval_fb48,...] [--seconds 2]

1. Which flags read true under a CUDA-only profiler session (the benchmark's
   first traced session) and under a CPU and CUDA one:
   ``torch.autograd._profiler_enabled()``, which the spans check, and
   ``torch.autograd.profiler._is_profiler_enabled``.
2. In each kind of session, ``--probes`` times: about 80 ms of matrix
   products, ``torch.cuda.synchronize()``, then a span around one elementwise
   launch and a synchronisation. Each probe's kernel is paired with its span:
   ``lead`` = kernel start - span start, ``lag`` = span end - kernel end (both
   µs). Were the span clock off the device timestamps by d, every lead would
   read its launch latency + d and every lag its return latency - d, so
   -min(lag) <= d <= min(lead). Also the span's device ms (its CUDA events)
   against the kernel's profiled duration.
3. ``--spans`` empty spans in a row, outside any session and under a
   CUDA-only one: the host µs a span costs, off and on.
4. With ``--cells``: each named benchmark cell run untraced through
   ``benchmark.harness.run_cell`` (a ``--seconds`` window), then the number of
   spans ``profiling.spans()`` holds (0 where spans are off).

Prints one JSON line a part, and the whole as the last line.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark.trace import device_ops, short_name  # noqa: E402
from onepose_plus_plus_tpu_torch.utils import profiling  # noqa: E402

ACT = torch.profiler.ProfilerActivity
SESSIONS = {"cuda_only": [ACT.CUDA], "cpu_cuda": [ACT.CPU, ACT.CUDA]}


def flags() -> dict:
    out = {}
    for name, acts in SESSIONS.items():
        with torch.profiler.profile(activities=acts):
            out[name] = {"_profiler_enabled": bool(torch.autograd._profiler_enabled()),
                         "_is_profiler_enabled": bool(torch.autograd.profiler._is_profiler_enabled)}
    out["outside"] = {"_profiler_enabled": bool(torch.autograd._profiler_enabled()),
                      "_is_profiler_enabled": bool(torch.autograd.profiler._is_profiler_enabled)}
    return out


def _stats(xs) -> dict:
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs)} if xs else {}


def probe(acts, n: int) -> dict:
    dev = torch.device("cuda", 0)
    a, b = torch.randn(4096, 4096, device=dev), torch.empty(4096, 4096, device=dev)
    x = torch.zeros(1 << 20, device=dev)
    torch.cuda.synchronize()
    profiling.spans(clear=True)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            for _ in range(30):  # about 80 ms of products
                torch.mm(a, a, out=b)
            torch.cuda.synchronize()
            with profiling.annotate("clock_probe"):
                x.add_(1.0)
                torch.cuda.synchronize()
    torch.cuda.synchronize()
    spans = [s for s in profiling.spans(clear=True) if s.name == "clock_probe"]
    kernels = [o for o in device_ops(prof) if "elementwise" in short_name(o.name)]
    del prof
    out = {"spans": len(spans), "kernels": len(kernels)}
    if len(spans) != len(kernels):
        return out
    lead = [(k.start_ns - s.start_ns) / 1e3 for s, k in zip(spans, kernels)]
    lag = [(s.end_ns - k.end_ns) / 1e3 for s, k in zip(spans, kernels)]
    dev_gap = [s.device_ms * 1e3 - (k.end_ns - k.start_ns) / 1e3 for s, k in zip(spans, kernels)
               if s.device_ms is not None]
    out.update(lead_us=_stats(lead), lag_us=_stats(lag), offset_bounds_us=[-min(lag), min(lead)],
               event_minus_kernel_us=_stats(dev_gap))
    return out


def cost(n: int) -> dict:
    """Host µs a span with an empty body costs, outside a session and under
    a CUDA-only one (CUDA initialised, so each span records its two events)."""
    torch.cuda.init()

    def per_span() -> float:
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with profiling.annotate("cost_probe"):
                pass
        return (time.perf_counter_ns() - t0) / n / 1e3

    profiling.spans(clear=True)
    off = per_span()
    with torch.profiler.profile(activities=[ACT.CUDA]):
        on = per_span()
    torch.cuda.synchronize()
    return {"spans": n, "recorded": len(profiling.spans(clear=True)), "off_us": off, "on_us": on}


def untraced(cells, seconds: float) -> dict:
    from benchmark import harness
    spec = harness.load_spec()
    out = {}
    for name in cells:
        cell, config, traffic = harness.load_cell(name, spec)
        profiling.spans(clear=True)
        ctx = harness.Context(cell, config, traffic, 2500000000 + len(out), torch.device("cuda", 0))
        res = harness.run_cell(ctx, seconds, False, time.perf_counter(), spec)
        out[name] = {"spans": len(profiling.spans()), "units": res["attempted"], "correct": res["correct"]}
        torch.cuda.empty_cache()
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--probes", type=int, default=100)
    p.add_argument("--spans", type=int, default=10000)
    p.add_argument("--cells", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args()
    result = {"device": torch.cuda.get_device_name(0), "torch": torch.__version__, "flags": flags()}
    print(json.dumps({"flags": result["flags"]}), flush=True)
    for name, acts in SESSIONS.items():
        result[name] = probe(acts, args.probes)
        print(json.dumps({name: result[name]}), flush=True)
    result["cost"] = cost(args.spans)
    print(json.dumps({"cost": result["cost"]}), flush=True)
    if args.cells:
        result["untraced"] = untraced([c for c in args.cells.split(",") if c], args.seconds)
        print(json.dumps({"untraced": result["untraced"]}), flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
