"""The port's spans (``utils/profiling.py::annotate``) and the benchmark's span
readers, on the CPU at tiny sizes.

A span records nothing outside a ``torch.profiler`` session; under one it
records its name, ids, counts and host interval on the profiler's own clock.
``run_inference``, the SfM surfaces and ``train_step`` open exactly the spans
the benchmark's readers read, and return bitwise the same results with a
session open. Each reader of ``benchmark/metrics`` computes its number from
a hand-made trace and span list, and none from a program without spans.
"""
import copy
import json
import types

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark import spans as bench_spans
from benchmark.trace import Op, Trace
from onepose_plus_plus_tpu_torch.inference.pipeline import run_inference
from onepose_plus_plus_tpu_torch.models.build import loftr_config_from_dict, make_loftr_fns, onepose_config_from_dict
from onepose_plus_plus_tpu_torch.models.loftr import LoFTRMatcher
from onepose_plus_plus_tpu_torch.models.onepose_plus import OnePosePlusModel
from onepose_plus_plus_tpu_torch.sfm.coarse_match import run_pairs
from onepose_plus_plus_tpu_torch.sfm.post_optimization import RefinementPair, run_fine_refinement
from onepose_plus_plus_tpu_torch.train.train_step import TrainConfig, make_optimizer, train_step
from onepose_plus_plus_tpu_torch.utils import profiling
from onepose_plus_plus_tpu_torch.utils.weights import random_state_dict

torch.set_num_threads(2)

CPU = [torch.profiler.ProfilerActivity.CPU]
TINY = {"loftr_backbone": {"initial_dim": 16, "block_dims": [16, 24, 32]},
        "keypoints_encoding": {"descriptor_dim": 32, "keypoints_encoder": [8, 16]},
        "loftr_coarse": {"d_model": 32, "nhead": 4, "layer_iter_n": 1},
        "match_coarse": {"thr": 0.0, "max_matches": 16, "train_max_matches": 16, "train_pad_num_gt_min": 4},
        "loftr_fine": {"d_model": 16, "nhead": 4}}


@pytest.fixture(autouse=True)
def _empty_buffer():
    profiling.spans(clear=True)
    yield
    profiling.spans(clear=True)


def _traced(fn):
    """``fn()`` under a CPU profiler session; (its result, the spans it recorded)."""
    profiling.spans(clear=True)
    with torch.profiler.profile(activities=CPU):
        out = fn()
    return out, profiling.spans(clear=True)


def _names(spans):
    return [s.name for s in sorted(spans, key=lambda s: s.id)]


# ------------------------------------------------------------------ the span


def test_no_span_is_recorded_outside_a_session():
    with profiling.annotate("outer", frames=3):
        with profiling.annotate("inner"):
            torch.ones(4).sum()
    with profiling.build_profiler("simple").record("region"):
        pass
    assert profiling.spans() == []


def test_nesting_gives_parent_root_and_counts():
    def work():
        with profiling.annotate("a", frames=4):
            with profiling.annotate("b", pairs=2):
                with profiling.annotate("c"):
                    pass
            with profiling.annotate("d"):
                pass
        with profiling.annotate("e"):
            pass

    _, spans = _traced(work)
    by = {s.name: s for s in spans}
    assert _names(spans) == ["a", "b", "c", "d", "e"]
    a, b, c, d, e = (by[k] for k in "abcde")
    assert (a.parent, a.root) == (None, a.id)
    assert (b.parent, b.root) == (a.id, a.id) and (c.parent, c.root) == (b.id, a.id)
    assert (d.parent, d.root) == (a.id, a.id) and (e.parent, e.root) == (None, e.id)
    assert a.counts == {"frames": 4} and b.counts == {"pairs": 2} and c.counts == {}
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns <= d.start_ns <= d.end_ns <= a.end_ns
    assert all(s.device_ms is None for s in spans)  # no CUDA here


def test_a_raising_body_records_nothing_and_leaves_no_span_open():
    def work():
        with pytest.raises(ValueError):
            with profiling.annotate("bad"):
                raise ValueError
        with profiling.annotate("next"):
            pass

    _, spans = _traced(work)
    assert [(s.name, s.parent, s.root == s.id) for s in spans] == [("next", None, True)]


def test_span_host_interval_matches_the_profilers_event():
    """Each span lies inside the profiler's own ``record_function`` event (20 µs
    of slack for the clocks), and its ends lie within 0.1 ms of the event's
    (median of 50; single spans can be preempted on a shared host)."""
    def work():
        with profiling.annotate("warm"):
            pass
        for i in range(50):
            with profiling.annotate(f"probe{i}"):
                torch.ones(8).sum()

    profiling.spans(clear=True)
    with torch.profiler.profile(activities=CPU) as prof:
        work()
    spans = {s.name: s for s in profiling.spans(clear=True)}
    events = {e.name(): e for e in prof.profiler.kineto_results.events() if e.name().startswith("probe")}
    assert len(events) == 50
    lead, lag = [], []
    for name, e in events.items():
        s, e_end = spans[name], e.start_ns() + e.duration_ns()
        assert e.start_ns() - 20_000 <= s.start_ns <= s.end_ns <= e_end + 20_000, name
        lead.append(s.start_ns - e.start_ns())
        lag.append(e_end - s.end_ns)
    assert np.median(lead) < 100_000 and np.median(lag) < 100_000


def test_chrome_profiler_lines_up_with_a_trace_export(tmp_path):
    """The chrome profiler's regions and the same regions in a ``trace()``
    export, that export's ``baseTimeNanoseconds`` added: each exported range
    inside its region (20 µs of slack), their ends within 0.1 ms (median)."""
    prof = profiling.build_profiler("chrome")
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("warm"):
            pass
        for i in range(20):
            with prof.record(f"region{i}"):
                torch.ones(8).sum()
    (path,) = prof.write(str(tmp_path / "chrome"))
    mine = {e["name"]: e for e in json.loads(open(path).read())["traceEvents"]}
    export = json.loads((tmp_path / "trace.json").read_text())
    base_us = export.get("baseTimeNanoseconds", 0) / 1e3
    theirs = {e["name"]: e for e in export["traceEvents"] if e.get("name") in mine}
    assert theirs.keys() == mine.keys()
    lead, lag = [], []
    for name, m in mine.items():
        t0, t1 = theirs[name]["ts"] + base_us, theirs[name]["ts"] + base_us + theirs[name]["dur"]
        assert m["ts"] - 20 <= t0 <= t1 <= m["ts"] + m["dur"] + 20, name
        lead.append(t0 - m["ts"])
        lag.append(m["ts"] + m["dur"] - t1)
    assert np.median(lead) < 100 and np.median(lag) < 100


# --------------------------------------------------- where the work happens


def _query_inputs():
    rng = np.random.default_rng(0)
    model = OnePosePlusModel(onepose_config_from_dict(TINY)).eval()
    model.load_state_dict(random_state_dict(model, seed=0))
    K = np.array([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]], np.float32)
    frames = [{"image": rng.integers(0, 255, (64, 64), dtype=np.uint8), "K": K,
               "pose_gt": np.eye(4, dtype=np.float32)} for _ in range(5)]
    anno = {"keypoints3d": rng.standard_normal((50, 3)).astype(np.float32) + [0, 0, 4],
            "descriptors3d": rng.standard_normal((50, 16)).astype(np.float32),
            "descriptors3d_coarse": rng.standard_normal((50, 32)).astype(np.float32)}
    return model, frames, anno


def test_run_inference_emits_the_named_spans_and_the_same_result():
    model, frames, anno = _query_inputs()
    kw = dict(shape3d=64, frame_batch=4, num_hypotheses=16, device=torch.device("cpu"))
    plain = run_inference(model, frames, anno, **kw)
    assert profiling.spans() == []
    traced, spans = _traced(lambda: run_inference(model, frames, anno, **kw))
    batch = ["run_inference.batch", "run_inference.stack", "run_inference.h2d", "query_step",
             "query_step.forward", "model.backbone", "query_step.pnp"]
    assert _names(spans) == ["run_inference", "run_inference.cloud"] + batch * 2
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    (root,) = by["run_inference"]
    assert root.counts == {"frames": 5} and all(s.root == root.id for s in spans)
    assert [s.counts for s in by["run_inference.batch"]] == [{"frames": 4}, {"frames": 4}]
    assert [s.counts for s in by["model.backbone"]] == [{"frames": 4}, {"frames": 4}]
    for f in ("poses", "num_inliers", "ok", "num_matches", "R_errs", "t_errs"):
        assert np.array_equal(getattr(plain, f), getattr(traced, f), equal_nan=True), f


def _sfm_inputs():
    rng = np.random.default_rng(1)
    cfg = {"layer_iter_n": 1, "match_coarse": {"thr": 0.0, "max_matches": 32}}
    model = LoFTRMatcher(loftr_config_from_dict(cfg)).eval()
    model.load_state_dict(random_state_dict(model, seed=1))
    base = np.kron(rng.random((8, 8)), np.ones((8, 8))).astype(np.float32)
    images = {i: np.roll(base, 4 * i, axis=1) for i in range(3)}
    return model, images


def test_sfm_surfaces_emit_the_named_spans_and_the_same_result():
    model, images = _sfm_inputs()
    coarse_fn, refine_fn, _ = make_loftr_fns(model)
    pairs = [(0, 1), (1, 2), (0, 2)]
    scales = {i: np.ones(2) for i in images}

    def work():
        raw = run_pairs(coarse_fn, images, scales, pairs, pair_batch=2)
        refine = [RefinementPair(pm.pair, pm.pts0.astype(np.float32), pm.pts1.astype(np.float32),
                                 np.arange(len(pm.pts0))) for pm in raw]
        return raw, run_fine_refinement(refine_fn, images, refine, match_capacity=32, pair_batch=2)

    raw, refined = work()
    assert profiling.spans() == []
    (raw_t, refined_t), spans = _traced(work)
    batch = ["sfm.stack", "sfm.h2d", "model.backbone", "sfm.d2h", "sfm.unpack"]
    assert _names(spans) == ["run_pairs"] + (batch + ["sfm.count"]) * 2 + ["run_fine_refinement"] + batch * 2
    roots = [s for s in spans if s.parent is None]
    assert [(s.name, s.counts) for s in roots] == [("run_pairs", {"pairs": 3}), ("run_fine_refinement", {"pairs": 3})]
    assert [s.counts for s in spans if s.name == "model.backbone"] == [{"frames": 4}] * 4
    for a, b in zip(raw, raw_t):
        assert a.pair == b.pair and np.array_equal(a.pts0, b.pts0) and np.array_equal(a.pts1, b.pts1)
        assert np.array_equal(a.conf, b.conf)
    assert refined.keys() == refined_t.keys()
    for k in refined:
        assert all(np.array_equal(refined[k][f], refined_t[k][f]) for f in refined[k])


def _train_batch(n=2, img=64, l=24):
    rng = np.random.default_rng(2)
    w_c = img // 8
    gt_cell = np.where(rng.random((n, l)) < 0.7, rng.integers(0, w_c * w_c, (n, l)), -1).astype(np.int32)
    cell = np.maximum(gt_cell, 0)
    centre = np.stack([cell % w_c, cell // w_c], -1) * 8.0
    return {"query_image": torch.from_numpy(rng.random((n, img, img, 1), np.float32)),
            "keypoints3d": torch.from_numpy(rng.standard_normal((n, l, 3)).astype(np.float32)),
            "descriptors3d": torch.from_numpy(rng.standard_normal((n, l, 16)).astype(np.float32)),
            "descriptors3d_coarse": torch.from_numpy(rng.standard_normal((n, l, 32)).astype(np.float32)),
            "gt_cell": torch.from_numpy(gt_cell),
            "gt_fine_xy": torch.from_numpy((centre + rng.uniform(-3, 3, (n, l, 2))).astype(np.float32))}


def _train(traced: bool):
    model = OnePosePlusModel(onepose_config_from_dict(TINY))
    model.load_state_dict(random_state_dict(model, seed=3))
    tc = TrainConfig(canonical_lr=1e-3, grad_accum=2)
    opt, sched = make_optimizer(model, tc, tc.true_lr(4), 10)
    gen = torch.Generator().manual_seed(0)
    batch = _train_batch()

    def steps():
        return [train_step(model, opt, batch, gen, tc, sched) for _ in range(2)]

    out, spans = _traced(steps) if traced else (steps(), profiling.spans())
    return model, out, spans


def test_train_step_emits_the_named_spans_and_the_same_result():
    model, out, none = _train(False)
    assert none == []
    model_t, out_t, spans = _train(True)
    step = ["train_step", "train_step.update", "train_step.forward", "model.backbone", "train_step.backward",
            "train_step.update"]
    assert _names(spans) == step * 2
    assert [s.counts for s in spans if s.name == "train_step"] == [{"frames": 2}] * 2
    for a, b in zip(out, out_t):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    for (n, p), q in zip(model.named_parameters(), model_t.parameters()):
        assert torch.equal(p, q), n


def test_an_untraced_benchmark_run_records_no_span():
    from benchmark.tests import tiny
    spec = harness.load_spec()
    entry = {c["name"]: c for c in spec["workloads"]}["query_eval_fb48"]
    ctx = harness.Context(entry, tiny.query_config(), tiny.query_traffic(), 4242424243, torch.device("cpu"))
    harness.run_cell(ctx, 0.2, False, 0.0, spec)
    assert profiling.spans() == []


# ------------------------------------------------------------------ readers


def _span(name, sid, start_ms, end_ms, device_ms=None, parent=None, root=None, **counts):
    return profiling.Span(name, sid, parent, root or sid, int(start_ms * 1e6), int(end_ms * 1e6), counts, device_ms)


def _trace(busy_ms, shapes=None):
    """A trace whose device ran in the given [start, end] ms intervals."""
    ops = [Op("kernel", int(a * 1e6), int(b * 1e6), "") for a, b in busy_ms]
    return Trace(ops=ops, window_s=1.0, work={}, shapes=shapes or {}, peak_bytes=0)


QUERY = [  # two batches of 48 frames; the device idles 2-12 and 60-70 ms, 20 ms in all
    _span("run_inference", 1, 0, 130, frames=96),
    _span("run_inference.cloud", 2, 0, 4, parent=1, root=1),
    _span("run_inference.batch", 3, 4, 65, parent=1, root=1, frames=48),
    _span("run_inference.stack", 4, 4, 8, parent=3, root=1),
    _span("run_inference.h2d", 5, 8, 12, parent=3, root=1),
    _span("query_step", 6, 12, 60, 50.0, parent=3, root=1),
    _span("query_step.forward", 15, 12, 29, 30.0, parent=6, root=1),
    _span("model.backbone", 7, 13, 20, 24.0, parent=15, root=1, frames=48),
    _span("query_step.pnp", 8, 30, 40, 10.0, parent=6, root=1),
    _span("run_inference.batch", 9, 65, 130, parent=1, root=1, frames=48),
    _span("run_inference.stack", 10, 65, 67, parent=9, root=1),
    _span("run_inference.h2d", 11, 67, 68, parent=9, root=1),
    _span("query_step", 12, 68, 128, 70.0, parent=9, root=1),
    _span("query_step.forward", 16, 68, 79, 40.0, parent=12, root=1),
    _span("model.backbone", 13, 69, 75, 24.0, parent=16, root=1, frames=48),
    _span("query_step.pnp", 14, 80, 90, 20.0, parent=12, root=1),
    _span("model.backbone", 18, 100, 110, 9.0, frames=8),  # a backbone call outside the query step
]
QUERY_BUSY = [(0, 2), (12, 60), (70, 128)]

SFM = [  # one batch of 2 pairs through both surfaces; the device idles 20-30 and 50-60 ms
    _span("run_pairs", 1, 0, 40, pairs=2),
    _span("sfm.stack", 2, 0, 2, parent=1, root=1),
    _span("sfm.h2d", 3, 2, 3, parent=1, root=1),
    _span("model.backbone", 4, 3, 10, 6.0, parent=1, root=1, frames=4),
    _span("sfm.d2h", 5, 18, 25, parent=1, root=1),
    _span("sfm.unpack", 6, 25, 29, parent=1, root=1),
    _span("run_fine_refinement", 7, 29, 80, pairs=2),
    _span("sfm.stack", 8, 29, 33, parent=7, root=7),
    _span("sfm.h2d", 9, 33, 35, parent=7, root=7),
    _span("model.backbone", 10, 35, 45, 8.0, parent=7, root=7, frames=4),
    _span("sfm.d2h", 11, 45, 52, parent=7, root=7),
    _span("sfm.unpack", 12, 52, 55, parent=7, root=7),
    _span("model.backbone", 13, 60, 61, 5.0, frames=1),  # outside both surfaces
]
SFM_BUSY = [(1, 20), (30, 50), (60, 61)]

TRAIN = [  # two micro-batches, the second one's update steps AdamW
    _span("train_step", 1, 0, 50, 48.0, frames=4),
    _span("train_step.update", 2, 0, 1, 0.5, parent=1, root=1),
    _span("train_step.forward", 3, 1, 20, 15.0, parent=1, root=1),
    _span("train_step.backward", 4, 20, 45, 30.0, parent=1, root=1),
    _span("train_step.update", 5, 45, 46, 0.5, parent=1, root=1),
    _span("train_step", 6, 50, 100, 60.0, frames=4),
    _span("train_step.update", 7, 50, 51, 1.0, parent=6, root=6),
    _span("train_step.forward", 8, 51, 70, 17.0, parent=6, root=6),
    _span("train_step.backward", 9, 70, 95, 32.0, parent=6, root=6),
    _span("train_step.update", 10, 95, 99, 8.0, parent=6, root=6),
]
TRAIN_BUSY = [(0, 100)]

READINGS = [
    # host ms of cloud + stacks + copies (4 + 4 + 4 + 2 + 1) over 2 batches
    ("host_input_ms.query", QUERY, QUERY_BUSY, 7.5),
    # idle 2-12 (cloud 2-4, stack 4-8, h2d 8-12: 10 ms) and 60-70 (stack 65-67, h2d 67-68: 3 ms) of 20
    ("idle_on_input_pct.query", QUERY, QUERY_BUSY, 65.0),
    ("pnp_pct.query", QUERY, QUERY_BUSY, 25.0),  # (10 + 20) / (50 + 70)
    ("backbone_ms.query", QUERY, QUERY_BUSY, 0.5),  # 48 ms over 96 frames
    # host ms of stack, h2d and unpack on both surfaces (2 + 1 + 4 + 4 + 2 + 3) over one batch
    ("host_io_ms.sfm", SFM, SFM_BUSY, 16.0),
    # idle 20-30 (d2h 20-25, unpack 25-29, stack 29-30: 10 ms) and 50-60 (d2h 50-52, unpack 52-55: 5 ms) of 20
    ("idle_on_io_pct.sfm", SFM, SFM_BUSY, 75.0),
    ("backbone_ms.sfm", SFM, SFM_BUSY, 7.0),  # 14 ms over 2 pairs
    ("forward_ms.train", TRAIN, TRAIN_BUSY, 16.0),
    ("backward_ms.train", TRAIN, TRAIN_BUSY, 31.0),
    ("update_ms.train", TRAIN, TRAIN_BUSY, 5.0),  # (0.5 + 0.5 + 1 + 8) over 2 micro-batches
]


def test_the_window_keeps_the_units_its_device_timeline_holds():
    spans = [
        _span("run_inference", 1, 0, 99.9, frames=4),  # an earlier session's unit, ended before the first operation
        _span("run_inference.batch", 2, 50, 99, parent=1, root=1),
        _span("run_inference", 3, 99.5, 150, frames=4),  # opened before the first operation and ran into it
        _span("run_inference.stack", 4, 99.5, 99.8, parent=3, root=3),
        _span("train_step", 5, 150, 199),
        _span("train_step", 6, 201, 250),  # opened after the last operation
        _span("train_step.forward", 7, 160, 170, parent=9, root=9),  # its root raised, and was not recorded
    ]
    assert [s.id for s in bench_spans.window_spans(_trace([(100, 110), (120, 200)]), spans)] == [3, 4, 5]
    assert bench_spans.window_spans(_trace([]), spans) == []


@pytest.mark.parametrize("metric,spans,busy,want", READINGS, ids=[r[0] for r in READINGS])
def test_reader_reads_the_hand_made_window(monkeypatch, metric, spans, busy, want):
    far = [_span("model.backbone", 99, 5000, 5010, 1000.0, frames=1)]  # another session, outside the window
    monkeypatch.setattr(bench_spans, "program_spans", lambda: copy.deepcopy(spans + far))
    assert harness.load_reader(metric)(_trace(busy)) == pytest.approx(want)


@pytest.mark.parametrize("metric", [r[0] for r in READINGS])
def test_reader_reads_nothing_from_a_program_without_spans(monkeypatch, metric):
    import onepose_plus_plus_tpu_torch.utils as utils
    monkeypatch.setattr(utils, "profiling", types.ModuleType("profiling"))
    monkeypatch.setitem(__import__("sys").modules, "onepose_plus_plus_tpu_torch.utils.profiling",
                        types.ModuleType("profiling"))
    assert bench_spans.program_spans() == []
    assert harness.load_reader(metric)(_trace([(0, 10), (20, 30)])) is None


@pytest.mark.parametrize("metric", [r[0] for r in READINGS])
def test_reader_reads_nothing_without_device_operations(monkeypatch, metric):
    spans = {r[0]: r[1] for r in READINGS}[metric]
    monkeypatch.setattr(bench_spans, "program_spans", lambda: copy.deepcopy(spans))
    assert harness.load_reader(metric)(_trace([])) is None


def test_every_span_reader_has_its_entry():
    spec = harness.load_spec()
    entries = {m["name"]: m for m in spec["per_layer"]}
    cells = {"query": "query_eval_fb48", "sfm": "sfm_match_pb8", "train": "train_mb4"}
    for metric, *_ in READINGS:
        m = entries[metric]
        assert m["source"] == "program_counter" and m["better"] == "lower"
        assert m["workloads"] == [cells[metric.rsplit(".", 1)[1]]]
        assert m["layer"] in ("host driver", "model")


def test_pnp_graph_share_reads_the_replays(monkeypatch):
    read = harness.load_reader("pnp_graph_pct.query")
    replayed = QUERY + [_span("pnp.graph", 17, 81, 89, 15.0, parent=14, root=1)]  # the second batch's PnP
    monkeypatch.setattr(bench_spans, "program_spans", lambda: copy.deepcopy(replayed))
    assert read(_trace(QUERY_BUSY)) == pytest.approx(50.0)
    assert read(_trace([])) is None
    monkeypatch.setattr(bench_spans, "program_spans", lambda: copy.deepcopy(QUERY))
    assert read(_trace(QUERY_BUSY)) is None  # a program without the graph: nothing to read


def test_pnp_graph_share_has_its_entry():
    m = {m["name"]: m for m in harness.load_spec()["per_layer"]}["pnp_graph_pct.query"]
    assert (m["source"], m["better"], m["layer"], m["moves"], m["workloads"]) == (
        "program_counter", "higher", "model", "query_poses_per_s", ["query_eval_fb48"])


# ------------------------------------------------- the full-match surface, the mesh gather


def test_full_match_surface_emits_the_named_spans_and_the_same_result():
    """``run_pairs`` over ``make_loftr_match_fn`` on images of mixed shapes:
    the padding, LoFTR's three stages under the ``run_pairs`` root, and the
    match and full-slot counts on ``sfm.count``; bitwise the same matches
    with a session open."""
    from onepose_plus_plus_tpu_torch.models.build import loftr_matcher_from_dict, make_loftr_match_fn
    model = loftr_matcher_from_dict({"match_coarse": {"thr": 0.0, "max_matches": 8}, "fine_window_size": 5,
                                     "fine_concat_coarse_feat": True}).eval()
    model.load_state_dict(random_state_dict(model, seed=4))
    rng = np.random.default_rng(5)
    base = np.kron(rng.random((8, 8)), np.ones((8, 8))).astype(np.float32)
    images = {0: base[:48], 1: base[:, :48], 2: base[8:56]}
    fn = make_loftr_match_fn(model)

    def work():
        return run_pairs(fn, images, {i: np.ones(2) for i in images}, [(0, 1), (1, 2), (0, 2)], pair_batch=2)

    raw = work()
    assert profiling.spans() == []
    raw_t, spans = _traced(work)
    batch = ["sfm.pad", "sfm.h2d", "loftr.coarse", "model.backbone", "loftr.match_coarse", "loftr.fine", "sfm.d2h",
             "sfm.unpack", "sfm.count"]
    assert _names(spans) == ["run_pairs"] + batch * 2
    assert all(s.root == spans[0].root for s in spans)
    unpack = [s.counts for s in sorted(spans, key=lambda s: s.id) if s.name == "sfm.count"]
    assert [c["matches"] for c in unpack] == [len(raw[0].pts0) + len(raw[1].pts0), len(raw[2].pts0)]
    assert all(c["slots_full"] == sum(len(pm.pts0) == 8 for pm in part) for c, part in zip(unpack, (raw[:2], raw[2:])))
    for a, b in zip(raw, raw_t):
        assert a.pair == b.pair and np.array_equal(a.pts0, b.pts0) and np.array_equal(a.pts1, b.pts1)


MD = [  # two batches of 4 pairs through the full-match surface
    _span("run_pairs", 1, 0, 100, pairs=8),
    _span("loftr.match_coarse", 2, 10, 20, 4.0, parent=1, root=1),
    _span("loftr.fine", 3, 20, 40, 10.0, parent=1, root=1),
    _span("sfm.unpack", 4, 45, 50, parent=1, root=1),
    _span("sfm.count", 9, 50, 50, parent=1, root=1, matches=9000, slots_full=1),
    _span("loftr.match_coarse", 5, 60, 70, 6.0, parent=1, root=1),
    _span("loftr.fine", 6, 70, 90, 14.0, parent=1, root=1),
    _span("sfm.unpack", 7, 95, 99, parent=1, root=1),
    _span("sfm.count", 10, 99, 99, parent=1, root=1, matches=7000, slots_full=0),
    _span("loftr.fine", 8, 200, 210, 50.0),  # outside the surface
]
MD_BUSY = [(5, 95)]
QUERY_X4 = QUERY + [_span("run_inference.gather", 19, 128, 129.5, parent=1, root=1)]

READINGS_NEW = [
    ("coarse_match_ms.md", MD, MD_BUSY, 1.25),  # (4 + 6) ms over 8 pairs
    ("fine_ms.md", MD, MD_BUSY, 3.0),  # (10 + 14) ms over 8 pairs
    ("slots_full_pct.md", MD, MD_BUSY, 12.5),  # 1 pair of 8
    ("gather_ms.query_x4", QUERY_X4, QUERY_BUSY, 1.5),  # 1.5 host ms over one object
]


@pytest.mark.parametrize("metric,spans,busy,want", READINGS_NEW, ids=[r[0] for r in READINGS_NEW])
def test_new_reader_reads_the_hand_made_window(monkeypatch, metric, spans, busy, want):
    monkeypatch.setattr(bench_spans, "program_spans", lambda: copy.deepcopy(spans))
    assert harness.load_reader(metric)(_trace(busy)) == pytest.approx(want)
    assert harness.load_reader(metric)(_trace([])) is None


@pytest.mark.parametrize("metric,spans", [("slots_full_pct.md", [s for s in MD if s.name != "sfm.count"]),
                                          ("slots_full_pct.md", [profiling.Span("sfm.count", 4, 1, 1, 50, 50, {})]
                                           + MD[:1]),
                                          ("gather_ms.query_x4", QUERY),
                                          ("coarse_match_ms.md", QUERY), ("fine_ms.md", SFM)])
def test_new_reader_reads_nothing_where_the_program_records_nothing(monkeypatch, metric, spans):
    """A program without the spans or counts (one older than them, or a
    window without a mesh) gives no reading, and raises nothing."""
    monkeypatch.setattr(bench_spans, "program_spans", lambda: copy.deepcopy(spans))
    assert harness.load_reader(metric)(_trace(MD_BUSY)) is None


def test_new_readers_have_their_entries():
    entries = {m["name"]: m for m in harness.load_spec()["per_layer"]}
    for metric, cell, moves, layer in (("coarse_match_ms.md", "loftr_md1200_pb4", "sfm_pairs_per_s", "model"),
                                       ("fine_ms.md", "loftr_md1200_pb4", "sfm_pairs_per_s", "model"),
                                       ("slots_full_pct.md", "loftr_md1200_pb4", "sfm_pairs_per_s", "model")):
        m = entries[metric]
        assert (m["source"], m["better"], m["moves"], m["layer"], m["workloads"]) == (
            "program_counter", "lower", moves, layer, [cell])
