"""A run whose timed path is broken underneath comes out not correct, once for
each fault a cell can have; the same run unbroken comes out correct. Tiny
sizes on the CPU, the cells' own limits; the harness's look for a GPU is
skipped (``run_cell`` on the CPU)."""
from __future__ import annotations

import pytest

from benchmark.tests import faults
from benchmark.tests.test_bench_reference import run_tiny

# each fault a cell can have: the matchers keep no state, so half a batch left out and an answer
# altered where it is produced (SfM: the coarse matches, and the 1/2 maps that refinement reads)
CASES = [("query_eval_fb48", faults.query, faults.ALTERED), ("query_eval_fb48", faults.query, faults.HALF),
         ("sfm_match_pb8", faults.sfm, faults.ALTERED), ("sfm_match_pb8", faults.sfm, faults.HALF),
         ("sfm_match_pb8", faults.sfm, faults.FINE_MAP),
         ("train_mb4", faults.train, faults.UNCHANGED), ("train_mb4", faults.train, faults.HALF),
         ("train_mb4", faults.train, faults.ALTERED)]


@pytest.mark.parametrize("cell", ["query_eval_fb48", "sfm_match_pb8", "train_mb4"])
def test_sound_run_is_correct(cell):
    out = run_tiny(cell, 2 ** 31 + 5)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell,plant,fault", CASES, ids=[f"{c}-{f}" for c, _, f in CASES])
def test_fault_is_not_correct(monkeypatch, cell, plant, fault):
    plant(monkeypatch, fault)
    out = run_tiny(cell, 2 ** 31 + 5)
    assert not out["correct"], out["checks"]
