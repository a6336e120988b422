"""Host milliseconds a batch of pairs that the SfM surfaces spend stacking
inputs (``sfm.stack``), copying them to the device (``sfm.h2d``) and
unpacking results (``sfm.unpack``), ``match_coarse`` and ``refine`` together,
over the window's ``run_pairs`` batches (their ``sfm.stack`` spans)."""
from benchmark import spans as sp


def read(t):
    s = sp.window_spans(t)
    roots = {x.id for x in sp.named(s, "run_pairs")}
    batches = sum(1 for x in sp.named(s, "sfm.stack") if x.parent in roots)
    return sp.per(sp.host_ms(sp.named(s, "sfm.stack", "sfm.h2d", "sfm.unpack")), batches)
