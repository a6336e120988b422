"""The plain reference against the program at a tiny size on the CPU, where
the program runs its plain versions in float32: each cell's check, driven by
the harness as a run drives it, finds the two in agreement."""
from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

CASES = {
    # cell: (config, traffic, largest reading of each number at this size)
    # both sides in float32: the same matches, maps and fine positions to rounding
    "query_eval_fb48": (tiny.query_config, tiny.query_traffic,
                        {"match_tail": 0.0, "fine_map_gap": 1e-6, "fine_p90_px": 1e-3}),
    "sfm_match_pb8": (tiny.sfm_config, tiny.sfm_traffic,
                      {"unshared_confident": 0.0, "fine_map_gap": 1e-6, "refine_p90_px": 1e-3}),
    # K5's plain version rounds the similarity's operands to bf16, as the kernel does
    "train_mb4": (tiny.train_config, tiny.train_traffic,
                  {"loss_gap": 5e-3, "grad_gap": 5e-2, "update_gap": 5e-2, "fine_grad_gap": 1e-3}),
}


def run_tiny(cell: str, seed: int, control: bool = False, seconds: float = 0.5) -> dict:
    config, traffic, _ = CASES[cell]
    spec = harness.load_spec()
    entry = {c["name"]: c for c in spec["workloads"]}[cell]
    ctx = harness.Context(entry, config(), traffic(), seed, torch.device("cpu"), control=control)
    return harness.run_cell(ctx, seconds, False, time.perf_counter(), spec)


@pytest.mark.parametrize("cell", sorted(CASES))
def test_program_agrees_with_the_reference(cell):
    out = run_tiny(cell, 2 ** 31 + 977)
    got = out["numbers"]
    for name, most in CASES[cell][2].items():
        assert got[name] <= most, (name, got)
    assert out["attempted"] >= 1 and out["failed"] == 0
