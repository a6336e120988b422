"""The port's hand-written CUDA kernels: build, launch helpers, launch counts.

Each kernel's wrapper lives beside its plain PyTorch version in ``ops/``:

- K1 ``ops/cuda_encoder.py::fused_encoder_layer`` and ``fused_encoder_layer_packed``
  (``csrc/encoder.cu``: tensor cores at C = 256 with 8 heads, bf16 operands or f32 ones
  in split TF32; ``csrc/encoder_tcw.cu``: tensor cores for bf16 operands at every
  other width, C a multiple of 32 up to 4096 with any head count that divides it;
  ``csrc/encoder_tcw_tf32.cu``: tensor cores in split TF32 for f32 operands at the
  same widths)
- K2 ``ops/cuda_matching.py::dual_softmax_rowcol_stats`` (``csrc/matching.cu``: tensor
  cores for bf16 operands (``pack_operand``) and, in split TF32, for f32 ones up to
  C = 576 (``pack_tf32_operand``); above 576, both dtypes on the channel-streaming
  tile of ``csrc/sim_tile_wide.cuh`` (``pack_wide_operand``, ``pack_tf32_hilo``))
- K3 ``ops/cuda_gather.py::window_gather`` (``csrc/gather.cu``: 16-byte vectors where a pixel
  is a multiple of 16 bytes, else K6's span copy, ``csrc/span.cuh``)
- K4 ``ops/cuda_gather.py::window_scatter`` (``csrc/scatter.cu``), K3's VJP: an index
  launch (``scatter_index``) and the sum launch (span sums in 16-byte chunks, ``csrc/span.cuh``)
- K5 ``ops/cuda_coarse_loss.py::fused_coarse_focal_loss`` (``csrc/coarse_loss.cu``, on
  K2's tensor-core tile), counted once per forward (``K5_coarse_loss``) and once per
  backward (``K5_coarse_loss_bwd``)
- K6 ``ops/cuda_patch_gather.py::patch_gather`` and ``patch_gather_centered``
  (``csrc/patch_gather.cu``), the patch gather at any corner
- K7 ``ops/cuda_short_encoder.py::fused_short_encoder_layer`` and
  ``fused_short_encoder_layer_packed`` (``csrc/short_encoder.cu``), the encoder
  layer over many short sequences: tensor cores for bf16 operands at C = 128
  with 8 heads, CUDA cores otherwise

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
    """The handle of ``device``'s current stream, which the kernels launch on
    (read without building a ``torch.cuda.Stream``: a few microseconds of host
    time a call less)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to TF32 as the kernels' ``cvt.rna.tf32.f32`` does: to
    nearest, ties away from zero, in an f32 container with the low 13 bits zero."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """(hi, lo): the split-TF32 halves of x that the kernels' ``tf32_split``
    (``csrc/wgmma.cuh``) computes, hi = tf32(x), lo = tf32(x - hi); hi + lo
    holds x to ~2^-22 relative."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the split-TF32 kernels compute it: three TF32 products of the
    :func:`tf32_split` halves, lo hi + hi lo + hi hi (lo lo dropped), summed in
    f32 (with TF32 matmul off, each product of two TF32 values is exact in f32)."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    return al @ bh + ah @ bl + ah @ bh
