"""Host milliseconds an object of ``run_inference``'s gather over the mesh
(``run_inference.gather``: one all-gather of every batch's rows and their
copy back) on rank 0, over the window's ``run_inference`` roots."""
from benchmark import spans as sp


def read(t):
    s = sp.window_spans(t)
    roots = {x.id for x in sp.named(s, "run_inference")}
    g = [x for x in sp.named(s, "run_inference.gather") if x.root in roots]
    return sp.per(sp.host_ms(g), len(roots)) if g else None
