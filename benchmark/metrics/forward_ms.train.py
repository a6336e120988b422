"""Device milliseconds a training micro-batch of the forward (the model and its losses):
``train_step.forward`` spans over the window's ``train_step`` spans."""
from benchmark import spans as sp


def read(t):
    s = sp.window_spans(t)
    return sp.per(sp.device_ms(sp.named(s, "train_step.forward")), len(sp.named(s, "train_step")))
