"""Profilers for the CLIs (port of ``onepose_plus_plus_tpu/utils/profiling.py``).

The registry of the reference's ``build_profiler`` names (``none``,
``simple``, ``advanced``, ``chrome``) with ``torch.profiler`` in place of
``jax.profiler``:

  * :class:`PassThroughProfiler` -- no-op with the ``record`` interface;
  * :class:`SimpleProfiler` -- wall time and calls per named action;
  * :class:`AdvancedProfiler` -- one ``cProfile`` per action; nested regions
    work (the inner region pauses the outer one's profile);
  * :class:`ChromeTraceProfiler` -- every region as a ``chrome://tracing``
    event;
  * :func:`trace` -- a ``torch.profiler`` trace (host and, on a GPU, device)
    written as a Chrome trace; :func:`annotate` -- a named range in it.

Every ``record`` region is also a ``torch.profiler.record_function`` range, so
it shows in a :func:`trace` taken around it. ``write(out_dir)`` writes what a
profiler keeps beyond its summary: the ``.pstats`` files of the advanced
profiler and the chrome profiler's trace (the JAX CLI never wrote them).
"""
from __future__ import annotations

import contextlib
import cProfile
import io
import json
import os
import pstats
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import torch


class PassThroughProfiler:
    """No-op profiler with the record interface."""

    @contextlib.contextmanager
    def record(self, name: str) -> Iterator[None]:
        yield

    def summary(self) -> str:
        return ""

    def write(self, out_dir: str) -> List[str]:
        """Write this profiler's files under ``out_dir``; returns their paths."""
        return []


class SimpleProfiler(PassThroughProfiler):
    """Wall time per action: cumulative duration and call count (reference
    SimpleProfiler semantics)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def record(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        if not self.totals:
            return "(no profiled actions)"
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        width = max(len(k) for k, _ in rows)
        lines = [f"{'Action':<{width}} |   Total (s) | Calls |  Mean (ms)"]
        for k, total in rows:
            n = self.counts[k]
            lines.append(f"{k:<{width}} | {total:11.3f} | {n:5d} | {total / n * 1e3:9.2f}")
        return "\n".join(lines)


class AdvancedProfiler(SimpleProfiler):
    """Per-action ``cProfile`` (reference AdvancedProfiler): the summary
    appends each action's top host functions to the wall-time table.

    Python allows one active ``cProfile`` at a time, so a region opened
    inside another pauses the outer region's profile until it closes: each
    action's profile holds its own time, not its nested actions'.
    """

    def __init__(self, top_n: int = 10):
        super().__init__()
        self.top_n = top_n
        self.profilers: Dict[str, cProfile.Profile] = {}
        self._active: List[cProfile.Profile] = []

    @contextlib.contextmanager
    def record(self, name: str) -> Iterator[None]:
        prof = self.profilers.setdefault(name, cProfile.Profile())
        if self._active:
            self._active[-1].disable()
        self._active.append(prof)
        prof.enable()
        try:
            with super().record(name):
                yield
        finally:
            prof.disable()
            self._active.pop()
            if self._active:
                self._active[-1].enable()

    def summary(self) -> str:
        out = [super().summary()]
        for name, prof in self.profilers.items():
            buf = io.StringIO()
            pstats.Stats(prof, stream=buf).strip_dirs().sort_stats("cumulative").print_stats(self.top_n)
            out.append(f"\n--- {name} (top {self.top_n} by cumulative) ---")
            out.append(buf.getvalue().rstrip())
        return "\n".join(out)

    def write(self, out_dir: str) -> List[str]:
        """One ``.pstats`` file per action (loadable with pstats/snakeviz)."""
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for name, prof in self.profilers.items():
            safe = name.replace("/", "_").replace(" ", "_")
            paths.append(os.path.join(out_dir, f"profile.{safe}.pstats"))
            prof.dump_stats(paths[-1])
        return paths


class ChromeTraceProfiler(SimpleProfiler):
    """Every region occurrence as a Catapult/Perfetto event (``chrome://tracing``
    JSON), the host-side analogue of the reference's PyTorch chrome-trace
    export; :func:`trace` adds the device."""

    def __init__(self):
        super().__init__()
        self.events: List[dict] = []

    @contextlib.contextmanager
    def record(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with super().record(name):
                yield
        finally:
            self.events.append({"name": name, "ph": "X", "ts": t0 * 1e6,
                                "dur": (time.perf_counter() - t0) * 1e6, "pid": 0, "tid": 0})

    def write(self, out_dir: str) -> List[str]:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "profile_trace.json")
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)
        return [path]


def build_profiler(name: Optional[str]) -> PassThroughProfiler:
    """Registry of the reference ``build_profiler`` names."""
    if name in (None, "none", "pass_through"):
        return PassThroughProfiler()
    if name in ("inference", "simple"):
        return SimpleProfiler()
    if name == "advanced":
        return AdvancedProfiler()
    if name in ("chrome", "pytorch"):
        return ChromeTraceProfiler()
    raise ValueError(f"unknown profiler {name!r}")


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """A ``torch.profiler`` trace of the enclosed work (the host, and the
    device where CUDA is available), written to ``log_dir/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range, visible in a :func:`trace`."""
    with torch.profiler.record_function(name):
        yield
