"""Share of the device's idle time in the traced window (the gaps between its
operations) that falls inside the SfM surfaces' host input and output spans
(``sfm.stack``, ``sfm.h2d``, ``sfm.d2h``, ``sfm.unpack``), on the profiler's
clock."""
from benchmark import spans as sp


def read(t):
    return sp.idle_inside_pct(t, sp.named(sp.window_spans(t), "sfm.stack", "sfm.h2d", "sfm.d2h", "sfm.unpack"))
