"""The SfM matching step's share of the bf16 peak: each pair's ``match_coarse``
(both backbones, the coarse transformer, the similarity) and ``refine`` (both
backbones and the coarse transformer again, the fine transformer and the
correlation on every slot) FLOPs, by ``benchmark.counts``, times the pairs of
the traced window, over its device span and 989 TFLOP/s."""
from benchmark import counts
from benchmark.readers import mfu_pct


def read(t):
    s = t.shapes
    flops = counts.loftr_match_coarse_flops(s["img"], s["model"]) + counts.loftr_refine_flops(
        s["img"], s["slots"], s["model"])
    return mfu_pct(t, flops, t.work.get("pairs", 0), "bf16")
