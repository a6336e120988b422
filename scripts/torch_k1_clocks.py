#!/usr/bin/env python3
"""Where one block of K1's tensor-core apply kernel spends its cycles.

    python3 scripts/torch_k1_clocks.py    # needs one Hopper GPU and nvcc

Builds the port's kernels with ``-DOPP_K1_CLOCKS``: one block of
``apply_tc_kernel`` (csrc/encoder.cu) then records ``clock64()`` at each phase
boundary. Runs one self layer at the query step's shape ([16, 7000, 256],
bf16 operands, random weights from a seed), prints the phases in cycles of
that block and each launch's device time (torch.profiler). No kernel profiler
runs on every machine; this is the view inside the kernel without one.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from onepose_plus_plus_tpu_torch import kernels  # noqa: E402
from onepose_plus_plus_tpu_torch.ops.cuda_encoder import (  # noqa: E402
    fused_encoder_layer_packed,
    pack_encoder_weights,
)

STATS_PHASES = (  # clocks 16..24
    "barrier init, block barrier",
    "start the source tile's and the first weight copies",
    "source tile: wait, round to bf16, store, proxy fence, block barrier",
    "K product",
    "elu+1, mask, K'^T store",
    "V product",
    "V^T store",
    "4 head-pair products K'^T V, sum K', partial store",
)
PHASES = (  # clocks 0..12
    "barrier init, block barrier",
    "start the x tile's, the first weight and the K'^T[V|1] copies",
    "x tile: wait, round to bf16, store, proxy fence, block barrier",
    "Q product",
    "elu+1, mask, Q' store (K'^T[V|1] has arrived)",
    "attention: 8 head products, normalise, msg store",
    "merge product",
    "LayerNorm 1, store",
    "FFN hidden: 4 products, ReLU, store",
    "FFN out: 2 products",
    "LayerNorm 2",
    "residual (x staged again during the FFN out products), y store",
)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    build_module = sys.modules[kernels.build.__module__]
    build_module.NVCC_FLAGS = build_module.NVCC_FLAGS + ("-DOPP_K1_CLOCKS",)
    lib = kernels.build()
    read_clocks = lib.lib.opp_encoder_tc_clocks
    read_clocks.argtypes, read_clocks.restype = [ctypes.c_void_p], ctypes.c_int

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    c = 256
    rn = lambda *shape, scale=1.0: torch.randn(*shape, generator=gen, device="cuda") * scale  # noqa: E731
    x = rn(16, 7000, c)
    packed = pack_encoder_weights(
        rn(c, c, scale=c ** -0.5), rn(c, c, scale=c ** -0.5), rn(c, c, scale=c ** -0.5),
        rn(c, c, scale=c ** -0.5), 1 + rn(c, scale=0.1), rn(c, scale=0.1),
        rn(2 * c, 2 * c, scale=(2 * c) ** -0.5), rn(2 * c, c, scale=(2 * c) ** -0.5),
        1 + rn(c, scale=0.1), rn(c, scale=0.1), nhead=8, dtype=torch.bfloat16)
    for _ in range(3):
        fused_encoder_layer_packed(x, x, packed)
    torch.cuda.synchronize()
    clocks = (ctypes.c_longlong * 32)()
    rc = read_clocks(clocks)
    if rc != 0:
        raise RuntimeError(f"reading the clocks failed with cudaError {rc}")
    for kernel, first, phases in (("kv_partial_tc_kernel", 16, STATS_PHASES), ("apply_tc_kernel", 0, PHASES)):
        total = clocks[first + len(phases)] - clocks[first]
        print(f"{kernel}, block (40, 8) of a self layer [16, 7000, 256]: {total} cycles")
        for i, name in enumerate(phases):
            d = clocks[first + i + 1] - clocks[first + i]
            print(f"  {d:8d} cycles  {100 * d / total:5.1f} %  {name}")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(10):
            fused_encoder_layer_packed(x, x, packed)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.device_type.name == "CUDA" and e.device_time_total > 0:
            print(f"  {e.device_time_total / 1e4:.4f} ms a call  {e.key[:80]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
