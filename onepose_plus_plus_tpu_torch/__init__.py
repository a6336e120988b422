"""OnePose++ in PyTorch with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``onepose_plus_plus_tpu`` (JAX, the reference it is tested
against). Slice 1 is the query-pose step: ``inference.pipeline``
(``make_query_step``, ``run_inference``) over ``models.onepose_plus``, with
kernels K1 (encoder layer), K2 (dual-softmax statistics) and K3 (fine-window
gather). Slice 2 is training on one device (``train``: losses, train step,
the ``python -m onepose_plus_plus_tpu_torch.train`` loop), with kernels K4
(the window gather's VJP) and K5 (the fused coarse focal loss). The kernels
live under ``csrc/`` and are built by ``kernels.build`` at first use.

It imports no JAX; from the JAX package it shares only the modules that load
none: ``config``, ``data.preprocessing``, ``data.dataset``, ``data.augment``
and the numpy functions of ``eval.metrics`` (and the training CLI loads
``utils/config_loader.py`` by its path).
"""

__version__ = "0.1.0"
