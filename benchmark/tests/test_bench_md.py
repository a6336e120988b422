"""The two drivers of LoFTR's outdoor cell and of the 4-GPU query cell, end to
end on the CPU at tiny sizes (the cells' own structure and limits): a sound
run comes out correct, and a run whose program is broken where the cell
looks comes out not correct. The query cell over the mesh runs four
processes over gloo."""
from __future__ import annotations

import copy
import json
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

SEED = 2 ** 31 + 5
# The 4-GPU query cell's entry as it would stand in BENCHMARK.json. The entry
# waits for a result line that reports all of a cell's devices (PERF.md, Open
# questions); its driver and traffic file are here and tested meanwhile.
MESH_CELL = {"name": "query_eval_fb192_x4", "config": "onepose_query", "traffic": "query_eval_fb192_x4", "chips": 4}


def md_context(seed: int = SEED) -> harness.Context:
    spec = harness.load_spec()
    entry, config, traffic = harness.load_cell("loftr_md1200_pb4", spec)
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    config["model"].update(compute_dtype="float32")
    config["model"]["match_coarse"].update(max_matches=64, thr=0.0)
    traffic.update(views_per_scene=5, long_side=96, short_side=64, pair_batch=2, covis_num=2, centre_views=2)
    traffic["object"].update(focal=93.75, tex_blocks=16, tex_block_px=8)
    traffic["check"].update(batches=1, fine_units=1, fine_pairs=1)
    return harness.Context(entry, config, traffic, seed, torch.device("cpu"))


def mesh_context(seed: int = SEED) -> harness.Context:
    traffic = json.loads((harness.BENCH_DIR / "workloads" / "query_eval_fb192_x4.json").read_text())
    small = tiny.query_traffic()
    for k in ("objects", "frames_per_object", "img", "shape3d", "ref_views", "point_margin_px", "object", "check"):
        traffic[k] = small[k]
    traffic.update(frame_batch=4, timeout_s=120, join_s=30)
    return harness.Context(MESH_CELL, tiny.query_config(), traffic, seed, torch.device("cpu"))


def run(ctx: harness.Context, seconds: float = 0.5) -> dict:
    return harness.run_cell(ctx, seconds, False, time.perf_counter(), harness.load_spec())


@pytest.fixture
def few_threads(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the mesh's other ranks, four processes on the CPU


def test_pairs_md_sound_run_is_correct():
    out = run(md_context())
    assert out["correct"], out["checks"]
    n = out["numbers"]
    assert n["padded_matches"] == 0 and n["matches_per_pair"] > 0 and out["attempted"] >= 1
    assert n["fine_input_gap"] < 1e-5  # float32 on both sides


def test_pairs_md_masks_dropped_are_not_correct(monkeypatch):
    """The padding masks dropped in the program: matches land in the padding
    and on the valid extent's border band, and the coarse matches move."""
    from onepose_plus_plus_tpu_torch.models.loftr import LoFTRMatcher
    match = LoFTRMatcher.match
    monkeypatch.setattr(LoFTRMatcher, "match", lambda self, img0, img1, mask0=None, mask1=None: match(self, img0, img1))
    out = run(md_context())
    assert not out["correct"], out["checks"]
    assert out["numbers"]["padded_matches"] > harness.load_cell("loftr_md1200_pb4", harness.load_spec())[2][
        "checks"]["padded_matches"]


def test_pairs_md_fine_preprocess_bypassed_is_not_correct(monkeypatch):
    """The fine preprocessing bypassed in the program (the windows reach the
    fine transformer unmerged): the coarse matches stay, and
    ``fine_input_gap`` rises above its limit."""
    from onepose_plus_plus_tpu_torch.models.loftr import FinePreprocess
    monkeypatch.setattr(FinePreprocess, "forward", lambda self, w0, w1, c0, c1: (w0, w1))
    out = run(md_context())
    assert not out["correct"], out["checks"]
    limits = harness.load_cell("loftr_md1200_pb4", harness.load_spec())[2]["checks"]
    assert out["numbers"]["fine_input_gap"] > limits["fine_input_gap"]
    assert out["numbers"]["padded_matches"] == 0


def test_query_mesh_sound_run_at_world_4_is_correct(few_threads):
    out = run(mesh_context(), 1.0)
    assert out["correct"], out["checks"]
    assert out["numbers"]["gather_exact"] == 0 and out["attempted"] >= 1


def test_query_mesh_catches_a_gather_that_leaves_a_rank_out(few_threads, monkeypatch):
    """Rank 0's gather with rank 1's rows replaced by its own: a quarter of
    the rows differ from what their owner computed."""
    from onepose_plus_plus_tpu_torch.inference import pipeline
    all_gather = pipeline.dist.all_gather

    def leave_out(parts, local):
        all_gather(parts, local)
        parts[1].copy_(parts[0])
    monkeypatch.setattr(pipeline.dist, "all_gather", leave_out)
    out = run(mesh_context(), 1.0)
    assert not out["correct"], out["checks"]
    assert out["numbers"]["gather_exact"] >= 0.25
