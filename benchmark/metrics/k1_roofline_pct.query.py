"""K1's share of its roofline in the query step: the least time of a layer
application (bf16 weights, float32 activations in and out, the coarse
transformer's 3D and image streams) times the applications the profiler
kept, over K1's device time."""
from benchmark.readers import K1_LAST, k1_bound_s, roofline_pct


def read(t):
    s = t.shapes
    co = s["model"]["loftr_coarse"]
    bound = k1_bound_s(s["frame_batch"], (s["n_points"], (s["img"] // 8) ** 2),
                       list(co["layer_names"]) * co["layer_iter_n"], co["d_model"], co["nhead"], 2, "bf16")
    return roofline_pct(t, "K1", K1_LAST, bound)
