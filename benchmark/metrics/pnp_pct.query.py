"""Share of the query step's device time (between the timing events of its
``query_step`` spans) spent in RANSAC-PnP (``query_step.pnp``)."""
from benchmark import spans as sp


def read(t):
    s = sp.window_spans(t)
    pnp, step = sp.device_ms(sp.named(s, "query_step.pnp")), sp.device_ms(sp.named(s, "query_step"))
    return 100.0 * pnp / step if pnp is not None and step else None
