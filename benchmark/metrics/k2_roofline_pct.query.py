"""K2's share of its roofline in the query step: the least time of a call (its
operand pack, the two passes and their reductions; float32 features in, row
and column statistics out, one bf16 similarity product) times the calls the
profiler kept, over K2's device time."""
from benchmark import counts
from benchmark.readers import K2_LAST, roofline_pct


def read(t):
    s = t.shapes
    n_bytes, ops = counts.k2_work(s["frame_batch"], s["n_points"], (s["img"] // 8) ** 2,
                                  s["model"]["loftr_coarse"]["d_model"])
    return roofline_pct(t, "K2", K2_LAST, counts.bound_s(n_bytes, ops, "bf16"))
