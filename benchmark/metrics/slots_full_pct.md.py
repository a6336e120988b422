"""Percent of the window's pairs whose valid matches filled every match slot:
the ``slots_full`` counts of the ``sfm.count`` spans under ``run_pairs``
roots, over the pairs those spans cover (their batches' real pairs, the
``run_pairs`` roots' counts). None where no span carries the count."""
from benchmark import spans as sp


def read(t):
    s = sp.window_spans(t)
    roots = sp.named(s, "run_pairs")
    ids = {x.id for x in roots}
    counted = [x for x in sp.named(s, "sfm.count") if x.root in ids and "slots_full" in x.counts]
    if not counted:
        return None
    return sp.per(100.0 * sum(x.counts["slots_full"] for x in counted), sum(x.counts.get("pairs", 0) for x in roots))
