"""The query step's share of the bf16 peak: the matcher's forward matrix FLOPs
a frame (backbone, keypoint encoder, coarse transformer, similarity, fine
stage, by ``benchmark.counts``) times the frames matched in the
traced window, over its device span and 989 TFLOP/s."""
from benchmark import counts
from benchmark.readers import mfu_pct


def read(t):
    s = t.shapes
    flops = counts.onepose_frame_flops(s["img"], s["n_points"], s["slots"], s["model"])
    return mfu_pct(t, flops, t.work.get("frames", 0), "bf16")
