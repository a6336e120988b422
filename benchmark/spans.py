"""What the span readers in ``benchmark/metrics`` share: the program's spans
(``onepose_plus_plus_tpu_torch.utils.profiling.spans()``) of the traced
window, and the sums they read.

A span records only while a ``torch.profiler`` session is open, on the
clock of the profiler's host events and of the device events it maps
(Unix-epoch nanoseconds). The window's spans are those of the units whose
root span ends after the window's first device operation starts and starts
before its last one ends. A traced run may profile its window more than once
(the harness profiles it anew right after a session that kept no device
operation); every root of an earlier session ended before the later session
opened, and so before its first device operation. A program without spans
(one older than them) gives none, and every reader then returns None.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

from .trace import Trace, gaps

# run_inference's host input spans, which both query input readers sum
QUERY_INPUT = ("run_inference.cloud", "run_inference.stack", "run_inference.h2d")


def program_spans() -> list:
    """Every span the program recorded, or none where it records none."""
    from onepose_plus_plus_tpu_torch.utils import profiling
    read = getattr(profiling, "spans", None)
    return list(read()) if read is not None else []


def window_spans(t: Trace, spans: Optional[Sequence] = None) -> list:
    """The spans of the units the traced window's device timeline holds (a
    span whose root was not recorded, its body having raised, is none)."""
    if not t.ops:
        return []
    lo, hi = t.ops[0].start_ns, max(o.end_ns for o in t.ops)
    spans = program_spans() if spans is None else list(spans)
    roots = {s.id: s for s in spans if s.root == s.id}
    return [s for s in spans if s.root in roots and roots[s.root].end_ns >= lo and roots[s.root].start_ns <= hi]


def named(spans: Iterable, *names: str) -> list:
    return [s for s in spans if s.name in names]


def host_ms(spans: Iterable) -> float:
    return sum(s.end_ns - s.start_ns for s in spans) / 1e6


def device_ms(spans: Sequence) -> Optional[float]:
    """Their device milliseconds, or None where any span has none (no CUDA)."""
    if not spans or any(s.device_ms is None for s in spans):
        return None
    return float(sum(s.device_ms for s in spans))


def per(total: Optional[float], n: float) -> Optional[float]:
    return total / n if total is not None and n > 0 else None


def union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def idle_inside_pct(t: Trace, spans: Sequence) -> Optional[float]:
    """100 x the device's idle time (gaps between the window's operations)
    that falls inside the spans' host intervals, over all its idle time."""
    idle = [(op.start_ns - ns, op.start_ns) for ns, op in gaps(t.ops)]
    total = sum(b - a for a, b in idle)
    if not spans or total <= 0:
        return None
    inside, held = 0, union((s.start_ns, s.end_ns) for s in spans)
    for a, b in idle:
        for c, d in held:
            if c >= b:
                break
            inside += max(0, min(b, d) - max(a, c))
    return 100.0 * inside / total
