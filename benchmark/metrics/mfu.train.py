"""The training step's share of the peak of the precision its convolutions run
in (TF32 where cuDNN's TF32 is on, as a fresh training process leaves it,
else float32): three times the forward matrix FLOPs a frame (the backward
counted as two forwards) at the training slots, times the frames of the
traced window, over its device span and the peak."""
from benchmark import counts
from benchmark.readers import mfu_pct


def read(t):
    s = t.shapes
    flops = 3 * counts.onepose_frame_flops(s["img"], s["n_points"], s["slots"], s["model"])
    return mfu_pct(t, flops, t.work.get("frames", 0), s["precision"])
