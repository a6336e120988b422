"""OnePose++ in PyTorch with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``onepose_plus_plus_tpu`` (JAX, the reference it is tested
against). Slice 1 is the query-pose step: ``inference.pipeline``
(``make_query_step``, ``run_inference``) over ``models.onepose_plus``, with
kernels K1 (encoder layer), K2 (dual-softmax statistics) and K3 (fine-window
gather). Slice 2 is training on one device (``train``: losses, train step,
the ``python -m onepose_plus_plus_tpu_torch.train`` loop), with kernels K4
(the window gather's VJP) and K5 (the fused coarse focal loss). The kernels
live under ``csrc/`` and are built by ``kernels.build`` at first use.

Slice 3 is the keypoint-free SfM (``sfm``: ``run_sfm`` and the
``python -m onepose_plus_plus_tpu_torch.sfm`` CLI over the LoFTR pair matcher
``models.loftr``, the epipolar, triangulation and depth solvers of
``geometry``), with kernel K6 (the patch gather at any corner).

Slice 4 is the serving entry points: the evaluation CLI
(``python -m onepose_plus_plus_tpu_torch.inference``), the one-line bench
(``python -m onepose_plus_plus_tpu_torch.bench``) and the tracking demo with
its detector (``python -m onepose_plus_plus_tpu_torch.demo``,
``inference.detector``), with kernel K7 (the encoder layer over many short
sequences, ``ops.cuda_short_encoder``; no path of the model routes to it).

It imports nothing of the JAX package: the host modules it needs
(``config``, ``data``, ``utils.config_loader``, the numpy ``eval``
functions, ``utils.visualization``) are its own copies, held to the originals
by ``tests/test_torch_host_copies.py``.
"""

__version__ = "0.1.0"
