"""The result line's keys and order, and a run without a GPU printing nothing."""
from __future__ import annotations

import subprocess
import sys
import time

import torch

from benchmark import harness
from benchmark.run import result_line
from benchmark.tests import tiny


def _run(trace: bool) -> dict:
    spec = harness.load_spec()
    entry = {c["name"]: c for c in spec["workloads"]}["query_eval_fb48"]
    ctx = harness.Context(entry, tiny.query_config(), tiny.query_traffic(), 4242424242, torch.device("cpu"))
    return harness.run_cell(ctx, 0.3, trace, time.perf_counter(), spec)


def test_measured_line():
    line = result_line(_run(False), False, "test")
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["metrics"]) == {"query_poses_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())


def test_traced_line():
    line = result_line(_run(True), True, "test")
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "query_poses_per_s" not in line["metrics"]


def test_no_gpu_no_result():
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "query_eval_fb48", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
                       timeout=300)
    if torch.cuda.is_available():
        return
    assert p.returncode != 0 and p.stdout.strip() == ""
