"""Device milliseconds a pair of LoFTR's fine stage in the full-match
surface: the ``loftr.fine`` spans (the fine preprocessing, the windows, the
fine transformer and the expectation) under the window's ``run_pairs``
roots, over the pairs those roots counted."""
from benchmark import spans as sp


def read(t):
    s = sp.window_spans(t)
    roots = sp.named(s, "run_pairs")
    ids = {x.id for x in roots}
    return sp.per(sp.device_ms([x for x in sp.named(s, "loftr.fine") if x.root in ids]),
                  sum(x.counts.get("pairs", 0) for x in roots))
