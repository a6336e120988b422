"""The port's profilers (``utils/profiling.py``) on the CPU.

The registry maps the reference's names to the same kinds of profiler as the
JAX package's. Beyond the JAX package, nested ``record`` regions work in every
profiler, ``write`` leaves the advanced profiler's ``.pstats`` files and the
chrome profiler's trace, and :func:`trace` writes a ``torch.profiler`` trace
in which :func:`annotate` ranges appear.
"""
import json
import pstats

import pytest
import torch

from onepose_plus_plus_tpu.utils import profiling as jax_profiling
from onepose_plus_plus_tpu_torch.utils import profiling

NAMES = [None, "none", "pass_through", "inference", "simple", "advanced", "chrome", "pytorch"]


@pytest.mark.parametrize("name", NAMES)
def test_registry_matches_the_jax_package(name):
    assert type(profiling.build_profiler(name)).__name__ == type(jax_profiling.build_profiler(name)).__name__


def test_unknown_name_raises():
    with pytest.raises(ValueError):
        profiling.build_profiler("tensorboard")


def _work(prof):
    with prof.record("outer"):
        torch.ones(64, 64) @ torch.ones(64, 64)
        for _ in range(2):
            with prof.record("inner"):
                torch.ones(8).sum()


@pytest.mark.parametrize("name", ["none", "simple", "advanced", "chrome"])
def test_nested_regions_are_recorded(name, tmp_path):
    prof = profiling.build_profiler(name)
    _work(prof)
    _work(prof)
    if name == "none":
        assert prof.summary() == "" and prof.write(str(tmp_path)) == []
        return
    assert dict(prof.counts) == {"outer": 2, "inner": 4}
    assert prof.totals["outer"] >= prof.totals["inner"] > 0
    summary = prof.summary()
    assert "outer" in summary and "inner" in summary


def test_advanced_profiler_writes_one_pstats_file_per_action(tmp_path):
    prof = profiling.build_profiler("advanced")
    _work(prof)
    paths = prof.write(str(tmp_path))
    assert sorted(p.rsplit("/", 1)[1] for p in paths) == ["profile.inner.pstats", "profile.outer.pstats"]
    for path in paths:
        assert pstats.Stats(path).total_calls > 0
    assert "top 10 by cumulative" in prof.summary()


def test_chrome_profiler_writes_every_region(tmp_path):
    prof = profiling.build_profiler("chrome")
    _work(prof)
    (path,) = prof.write(str(tmp_path))
    events = json.loads(open(path).read())["traceEvents"]
    assert sorted(e["name"] for e in events) == ["inner", "inner", "outer"]
    outer = next(e for e in events if e["name"] == "outer")
    for e in events:  # the inner regions lie inside the outer one
        assert outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]


def test_trace_writes_annotated_ranges(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("my_region"):
            torch.ones(32, 32) @ torch.ones(32, 32)
        with profiling.build_profiler("simple").record("recorded_region"):
            torch.ones(8).sum()
    names = {e.get("name") for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {"my_region", "recorded_region"} <= names
