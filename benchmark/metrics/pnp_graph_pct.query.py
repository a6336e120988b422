"""Share of the query step's RANSAC-PnP calls (``query_step.pnp`` spans) that
replayed a CUDA graph (``pnp.graph`` spans, one a replay); nothing where the
window holds no ``pnp.graph`` span (a program without the graph)."""
from benchmark import spans as sp


def read(t):
    s = sp.window_spans(t)
    graph, pnp = sp.named(s, "pnp.graph"), sp.named(s, "query_step.pnp")
    return 100.0 * len(graph) / len(pnp) if graph and pnp else None
