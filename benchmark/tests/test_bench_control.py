"""The control comes out not correct: each cell's run through the harness
with the program's own lower-precision path switched on (the int8 backbone
for the bf16 matchers, with float8 operands in their fine stages; bf16 for
float32 training), at the cell's own size on the GPU, three seeds, a short
window. Run on the card: ``python3 -m pytest --noconftest benchmark/tests/test_bench_control.py -m cuda``."""
from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness

CELLS = [c["name"] for c in harness.load_spec()["workloads"] if c["chips"] == 1]


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's own size on an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [2 ** 31 + 71, 2 ** 31 + 72, 2 ** 31 + 73])
def test_control_is_not_correct(gpu, cell, seed):
    spec = harness.load_spec()
    entry, config, traffic = harness.load_cell(cell, spec)
    ctx = harness.Context(entry, config, traffic, seed, gpu, control=True)
    out = harness.run_cell(ctx, 4.0, False, time.perf_counter(), spec)
    assert not out["correct"], out["checks"]
