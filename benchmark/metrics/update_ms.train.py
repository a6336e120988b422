"""Device milliseconds a training micro-batch of the update: the running
mean's scaling, the accumulation and, every ``grad_accum`` micro-batches, the
AdamW step (``train_step.update`` spans), averaged over every micro-batch of
the window (its ``train_step`` spans), not only the update micro-batches."""
from benchmark import spans as sp


def read(t):
    s = sp.window_spans(t)
    return sp.per(sp.device_ms(sp.named(s, "train_step.update")), len(sp.named(s, "train_step")))
