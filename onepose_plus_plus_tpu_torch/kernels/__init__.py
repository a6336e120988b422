"""The port's hand-written CUDA kernels: build, launch helpers, launch counts.

Each kernel's wrapper lives beside its plain PyTorch version in ``ops/``:

- K1 ``ops/cuda_encoder.py::fused_encoder_layer`` and ``fused_encoder_layer_packed``
  (``csrc/encoder.cu``: tensor cores for bf16 operands at C = 256 with 8 heads, CUDA
  cores for f32 and for bf16 at other widths)
- K2 ``ops/cuda_matching.py::dual_softmax_rowcol_stats`` (``csrc/matching.cu``: tensor
  cores for bf16 operands, which ``pack_operand`` lays out first, CUDA cores for f32)
- K3 ``ops/cuda_gather.py::window_gather`` (``csrc/gather.cu``)
- K4 ``ops/cuda_gather.py::window_scatter`` (``csrc/scatter.cu``), K3's VJP: an index
  launch (``scatter_index``) and the scatter launch
- K5 ``ops/cuda_coarse_loss.py::fused_coarse_focal_loss`` (``csrc/coarse_loss.cu``, on
  K2's tensor-core tile), counted once per forward (``K5_coarse_loss``) and once per
  backward (``K5_coarse_loss_bwd``)
- K6 ``ops/cuda_patch_gather.py::patch_gather`` (``csrc/patch_gather.cu``), the
  patch gather at any corner
- K7 ``ops/cuda_short_encoder.py::fused_short_encoder_layer``
  (``csrc/short_encoder.cu``), the encoder layer over many short sequences

A wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises. Each wrapper adds one to its entry of
``LAUNCHES`` where it launches its kernel, and nowhere else.
"""
from __future__ import annotations

from typing import Dict

import torch

from .build import build  # noqa: F401

LAUNCHES: Dict[str, int] = {
    "K1_encoder_layer": 0,
    "K2_rowcol_stats": 0,
    "K3_window_gather": 0,
    "K4_window_scatter": 0,
    "K5_coarse_loss": 0,
    "K5_coarse_loss_bwd": 0,
    "K6_patch_gather": 0,
    "K7_short_encoder": 0,
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def check_cuda_operands(name: str, *tensors: torch.Tensor) -> torch.device:
    """Raise unless every tensor is a contiguous CUDA tensor on the current device."""
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {device}")
    if device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors on {device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: mixed devices {device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)} is not contiguous")
    return device


def ptr(t):
    """Device pointer of a tensor (None stays NULL)."""
    return None if t is None else t.data_ptr()


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
