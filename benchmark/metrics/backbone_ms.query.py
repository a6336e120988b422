"""Device milliseconds a frame of the backbone in the query step: the
``model.backbone`` spans inside ``query_step.forward``, over the frames they
counted."""
from benchmark import spans as sp


def read(t):
    s = sp.window_spans(t)
    forward = {x.id for x in sp.named(s, "query_step.forward")}
    b = [x for x in sp.named(s, "model.backbone") if x.parent in forward]
    return sp.per(sp.device_ms(b), sum(x.counts.get("frames", 0) for x in b))
