"""K6's share of its roofline in ``refine``: the bytes a launch must move on the
window's matches (its 9 x 9 windows of the bf16 fine map written once, the
distinct map pixels they cover read once, the centres read once), over the
memory rate, times the launches the profiler kept, over K6's device time."""
from benchmark import counts
from benchmark.readers import K6_LAST, roofline_pct


def read(t):
    return roofline_pct(t, "K6", K6_LAST, counts.bound_s(t.shapes["k6_bytes"], 0.0, "bf16"))
