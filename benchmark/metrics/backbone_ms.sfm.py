"""Device milliseconds a pair of the backbone over both SfM surfaces: the
``model.backbone`` spans under ``run_pairs`` (``match_coarse``) and
``run_fine_refinement`` (``refine``), over the pairs the window's
``run_pairs`` spans counted. Each surface runs a pair's two images through
it, so this counts ``refine`` recomputing ``match_coarse``'s backbone."""
from benchmark import spans as sp


def read(t):
    s = sp.window_spans(t)
    coarse = sp.named(s, "run_pairs")
    roots = {x.id for x in coarse + sp.named(s, "run_fine_refinement")}
    b = [x for x in sp.named(s, "model.backbone") if x.root in roots]
    return sp.per(sp.device_ms(b), sum(x.counts.get("pairs", 0) for x in coarse))
