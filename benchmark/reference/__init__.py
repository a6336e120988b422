"""The benchmark's plain reference: PyTorch and NumPy only, nothing of the
program under test. :func:`exact_fp32` turns TF32 off while it runs, so that
every float32 product of the reference is a float32 product."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def exact_fp32():
    """Float32 matrix products and convolutions without TF32, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
