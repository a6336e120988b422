"""Device milliseconds a training micro-batch of the backward:
``train_step.backward`` spans over the window's ``train_step`` spans."""
from benchmark import spans as sp


def read(t):
    s = sp.window_spans(t)
    return sp.per(sp.device_ms(sp.named(s, "train_step.backward")), len(sp.named(s, "train_step")))
