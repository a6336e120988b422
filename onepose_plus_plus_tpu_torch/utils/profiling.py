"""Profilers for the CLIs (port of ``onepose_plus_plus_tpu/utils/profiling.py``),
and the port's spans.

The registry of the reference's ``build_profiler`` names (``none``,
``simple``, ``advanced``, ``chrome``) with ``torch.profiler`` in place of
``jax.profiler``:

  * :class:`PassThroughProfiler` -- no-op with the ``record`` interface;
  * :class:`SimpleProfiler` -- wall time and calls per named action;
  * :class:`AdvancedProfiler` -- one ``cProfile`` per action; nested regions
    work (the inner region pauses the outer one's profile);
  * :class:`ChromeTraceProfiler` -- every region as a ``chrome://tracing``
    event, stamped on the span clock;
  * :func:`trace` -- a ``torch.profiler`` trace (host and, on a GPU, device)
    written as a Chrome trace.

:func:`annotate` is the port's one span: every ``record`` region opens one,
and the hot paths open them where their work happens (``run_inference``,
the query step, the backbone, the SfM surfaces, ``train_step``). Outside a
``torch.profiler`` session a span checks one flag and records nothing. Under
a session it opens a ``record_function`` range (so it shows in any export,
on the host row and as the device's user annotation) and records, in a
bounded in-memory buffer: its name, its id, its parent's and its root's ids
(the root is the outermost open span), its counts (``frames=48``), its host
start and end on :func:`clock_ns` (Unix-epoch nanoseconds, the clock of the
profiler's host events and of the device events it maps), and, where CUDA is
initialised, a timing event at each end on the current stream (never a
synchronisation). :func:`spans` returns the records, each with the device
milliseconds between its events once they have completed: read it after
synchronising.

``write(out_dir)`` writes what a profiler keeps beyond its summary: the
``.pstats`` files of the advanced profiler and the chrome profiler's trace
(the JAX CLI never wrote them). The chrome profiler's ``ts`` are
microseconds on the span clock; a :func:`trace` export gives its ``ts``
relative to its ``baseTimeNanoseconds``, and adding that base lines the two
files up.
"""
from __future__ import annotations

import collections
import contextlib
import cProfile
import dataclasses
import io
import itertools
import json
import os
import pstats
import threading
import time
from collections import defaultdict
from typing import Deque, Dict, Iterator, List, Optional, Tuple

import torch

MAX_SPANS = 1 << 16  # the buffer keeps the newest spans


def clock_ns() -> int:
    """The span clock: Unix-epoch nanoseconds, on which ``torch.profiler``
    stamps its host events and maps its device events."""
    return time.time_ns()


@dataclasses.dataclass
class Span:
    """One recorded span (:func:`annotate`)."""

    name: str
    id: int
    parent: Optional[int]  # the enclosing recorded span's id
    root: int  # the outermost recorded span's id (its own where it is outermost)
    start_ns: int  # host, on clock_ns()
    end_ns: int
    counts: Dict[str, int]
    device_ms: Optional[float] = None  # between its timing events, once both have completed
    events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = dataclasses.field(
        default=None, repr=False, compare=False)


_SPANS: Deque[Span] = collections.deque(maxlen=MAX_SPANS)
_IDS = itertools.count(1)
_OPEN = threading.local()  # this thread's open spans: (id, root) pairs


@contextlib.contextmanager
def annotate(name: str, **counts: int) -> Iterator[None]:
    """A span named ``name`` (module docstring); records only under a
    ``torch.profiler`` session."""
    if not torch.autograd._profiler_enabled():
        yield
        return
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    sid = next(_IDS)
    parent, root = stack[-1] if stack else (None, sid)
    events = None
    if torch.cuda.is_initialized():
        events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    stack.append((sid, root))
    try:  # a span whose body raises is not recorded
        with torch.profiler.record_function(name):
            if events is not None:
                events[0].record()
            start = clock_ns()
            yield
            end = clock_ns()
            if events is not None:
                events[1].record()
    finally:
        stack.pop()
    _SPANS.append(Span(name, sid, parent, root, start, end, counts, events=events))


def spans(clear: bool = False) -> List[Span]:
    """The recorded spans, oldest first, each span's ``device_ms`` resolved
    where both its events have completed; ``clear`` empties the buffer."""
    out = list(_SPANS)
    for s in out:
        if s.events is not None and s.events[1].query():
            s.device_ms = s.events[0].elapsed_time(s.events[1])
            s.events = None
    if clear:
        _SPANS.clear()
    return out


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
            with annotate(name):
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
    export, stamped on the span clock; :func:`trace` adds the device."""

    def __init__(self):
        super().__init__()
        self.events: List[dict] = []

    @contextlib.contextmanager
    def record(self, name: str) -> Iterator[None]:
        t0 = clock_ns()
        try:
            with super().record(name):
                yield
        finally:
            self.events.append({"name": name, "ph": "X", "ts": t0 / 1e3,
                                "dur": (clock_ns() - t0) / 1e3, "pid": 0, "tid": 0})

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
