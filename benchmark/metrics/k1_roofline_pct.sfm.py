"""K1's share of its roofline in LoFTR's coarse transformer (both surfaces):
the least time of a layer application over ``pair_batch`` image pairs (both
streams of (img / 8)^2 tokens, bf16 weights, float32 activations) times the
applications the profiler kept, over K1's device time."""
from benchmark.readers import K1_LAST, k1_bound_s, roofline_pct


def read(t):
    s = t.shapes
    m = s["model"]
    grid = (s["img"] // 8) ** 2
    bound = k1_bound_s(s["pair_batch"], (grid, grid), ["self", "cross"] * m["layer_iter_n"], m["d_model"],
                       m["nhead"], 2, "bf16")
    return roofline_pct(t, "K1", K1_LAST, bound)
