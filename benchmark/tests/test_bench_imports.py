"""Nothing the benchmark runs on the card loads JAX or the JAX package, by
whole top-level module names (the port's name begins with the JAX
package's), and the reference loads nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from benchmark import harness

BENCH = harness.BENCH_DIR


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    for path in BENCH.rglob("*.py"):
        assert not set(_imports(path)) & set(harness.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "onepose_plus_plus_tpu_torch" not in set(_imports(path)), path


def test_a_run_loads_no_jax():
    code = ("import time, torch, sys; from benchmark import harness; from benchmark.tests import tiny; "
            "spec = harness.load_spec(); e = spec['workloads'][0]; "
            "c = harness.Context(e, tiny.query_config(), tiny.query_traffic(), 7, torch.device('cpu')); "
            "harness.run_cell(c, 0.2, False, time.perf_counter(), spec); "
            "print(harness.forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole():
    assert harness.forbidden_modules(["onepose_plus_plus_tpu_torch.models", "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["onepose_plus_plus_tpu.models", "jax.numpy", "flax"]) == [
        "flax", "jax", "onepose_plus_plus_tpu"]
