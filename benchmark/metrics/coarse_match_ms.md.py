"""Device milliseconds a pair of LoFTR's coarse matching in the full-match
surface: the ``loftr.match_coarse`` spans (K2 and the slot selection) under
the window's ``run_pairs`` roots, over the pairs those roots counted."""
from benchmark import spans as sp


def read(t):
    s = sp.window_spans(t)
    roots = sp.named(s, "run_pairs")
    ids = {x.id for x in roots}
    return sp.per(sp.device_ms([x for x in sp.named(s, "loftr.match_coarse") if x.root in ids]),
                  sum(x.counts.get("pairs", 0) for x in roots))
