"""What the per-layer readers in ``benchmark/metrics`` share: each takes a
:class:`benchmark.trace.Trace` and returns a number, or None where the trace
holds nothing to read (the harness then leaves the metric out). A roofline
share divides the least time of the launches the profiler kept by their
device time; it is never clipped."""
from __future__ import annotations

from typing import Iterable, Optional

from . import counts
from .trace import Trace, short_name

# the launch that ends one call of a kernel, by instance
K1_LAST = ("apply_tc_kernel", "tcw_ln_residual_kernel", "tcw32_ln_residual_kernel")
K2_LAST = ("col_argmax_reduce",)
K6_LAST = ("patch_gather_kernel",)


def idle_pct(t: Trace) -> Optional[float]:
    if not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.span_s)


def peak_gib(t: Trace) -> Optional[float]:
    return t.peak_bytes / 2 ** 30 if t.peak_bytes else None


def calls(t: Trace, last: Iterable[str]) -> int:
    last = set(last)
    return sum(1 for o in t.ops if short_name(o.name) in last)


def roofline_pct(t: Trace, family: str, last: Iterable[str], bound_s_per_call: float) -> Optional[float]:
    """100 x (calls kept x least seconds a call) / the family's device seconds."""
    n, busy = calls(t, last), t.seconds(t.family_ops(family))
    if n == 0 or busy <= 0:
        return None
    return 100.0 * n * bound_s_per_call / busy


def mfu_pct(t: Trace, flops_per_unit: float, units: float, precision: str) -> Optional[float]:
    """100 x the traced window's model FLOPs / its device span (first operation's
    start to the last one's end, on the device clock) / the peak."""
    if units <= 0 or t.span_s <= 0:
        return None
    return 100.0 * flops_per_unit * units / t.span_s / counts.PEAK_FLOPS[precision]


def k1_bound_s(n: int, streams, names, c: int, nhead: int, weight_bytes: int, precision: str) -> float:
    """Mean least seconds of one K1 layer application of a two-stream
    transformer over n sequences (streams: the two lengths)."""
    l0, l1 = streams
    apps = []
    for name in names:
        pairs = [(l0, l0), (l1, l1)] if name == "self" else [(l0, l1), (l1, l0)]
        apps += [counts.bound_s(counts.encoder_layer_bytes(n, l, s, c, weight_bytes),
                                n * counts.encoder_layer_ops(l, s, c, nhead), precision) for l, s in pairs]
    return sum(apps) / len(apps)
