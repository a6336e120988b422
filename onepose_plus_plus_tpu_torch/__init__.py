"""OnePose++ in PyTorch with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``onepose_plus_plus_tpu`` (JAX, the reference it is tested
against). Slice 1 is the query-pose step: ``inference.pipeline``
(``make_query_step``, ``run_inference``) over ``models.onepose_plus``, with
kernels K1 (encoder layer), K2 (dual-softmax statistics) and K3 (fine-window
gather) under ``csrc/``, built by ``kernels.build`` at first use.

It imports no JAX; from the JAX package it shares only the modules that load
none: ``config``, ``data.preprocessing`` and the numpy functions of
``eval.metrics``.
"""

__version__ = "0.1.0"
