"""Share of the device's idle time in the traced window (the gaps between its
operations) that falls inside ``run_inference``'s input spans (the cloud's
upload, the stacking, the H2D copies), on the profiler's clock."""
from benchmark import spans as sp


def read(t):
    return sp.idle_inside_pct(t, sp.named(sp.window_spans(t), *sp.QUERY_INPUT))
