"""Host milliseconds a batch that ``run_inference`` spends making a batch's
input: the point cloud's padding and upload (``run_inference.cloud``, once
an object), the stacking (``run_inference.stack``) and the H2D copies
(``run_inference.h2d``), over the ``run_inference.batch`` spans of the
window's ``run_inference`` calls."""
from benchmark import spans as sp


def read(t):
    s = sp.window_spans(t)
    calls = {x.id for x in sp.named(s, "run_inference")}
    batches = sum(1 for x in sp.named(s, "run_inference.batch") if x.root in calls)
    return sp.per(sp.host_ms(sp.named(s, *sp.QUERY_INPUT)), batches)
