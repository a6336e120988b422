#!/usr/bin/env python3
"""Where K7's tensor-core kernel spends its cycles, phase by phase.

    python3 scripts/torch_k7_clocks.py    # needs one Hopper GPU and nvcc

Builds the port's kernels with ``-DOPP_K7_CLOCKS``: block 0 of
``short_encoder_tc_kernel`` (csrc/short_encoder.cu) then adds, tile by tile,
the ``clock64()`` cycles of each phase of the layer. Runs the four (L, S)
shapes of the fine transformer at M 8192 (bf16 operands, random weights from
a seed) and prints, for each, the phases of block 0 over its tiles and the
launch's device time (torch.profiler). No kernel profiler runs on every
machine; this is the view inside the kernel without one.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from onepose_plus_plus_tpu_torch import kernels  # noqa: E402
from onepose_plus_plus_tpu_torch.ops.cuda_short_encoder import (  # noqa: E402
    fused_short_encoder_layer_packed,
    pack_short_encoder_weights,
    short_tile_plan,
)

PHASES = (
    "x (and source) rows: load, round to bf16, store; proxy fence, block barrier",
    "K, V, Q products (6 weight chunks), elu+1, stores",
    "attention: 8 heads x (one m64n128 score product, mask, row sums, 8 m64n16 products), msg store",
    "merge product (2 chunks), LayerNorm 1, store",
    "FFN hidden: 2 x 4 chunks, ReLU, stores",
    "FFN out (4 chunks), LayerNorm 2, residual, y store",
)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    build_module = sys.modules[kernels.build.__module__]
    build_module.NVCC_FLAGS = build_module.NVCC_FLAGS + ("-DOPP_K7_CLOCKS",)
    lib = kernels.build()
    read_clocks = lib.lib.opp_short_encoder_tc_clocks
    read_clocks.argtypes, read_clocks.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    c, m = 128, 8192
    rn = lambda *shape, scale=1.0: torch.randn(*shape, generator=gen, device="cuda") * scale  # noqa: E731
    packed = pack_short_encoder_weights(
        rn(c, c, scale=c ** -0.5), rn(c, c, scale=c ** -0.5), rn(c, c, scale=c ** -0.5),
        rn(c, c, scale=c ** -0.5), 1 + rn(c, scale=0.1), rn(c, scale=0.1),
        rn(2 * c, 2 * c, scale=(2 * c) ** -0.5), rn(2 * c, c, scale=(2 * c) ** -0.5),
        1 + rn(c, scale=0.1), rn(c, scale=0.1), nhead=8, dtype=torch.bfloat16)
    clocks = (ctypes.c_longlong * 8)()
    for l, s in ((25, 25), (1, 1), (1, 25), (25, 1)):
        x = rn(m, l, c)
        src = x if l == s else rn(m, s, c)
        for _ in range(3):
            fused_short_encoder_layer_packed(x, src, packed)
        torch.cuda.synchronize()
        if read_clocks(clocks, 1) != 0:
            raise RuntimeError("resetting the clocks failed")
        fused_short_encoder_layer_packed(x, src, packed)
        torch.cuda.synchronize()
        if read_clocks(clocks, 1) != 0:
            raise RuntimeError("reading the clocks failed")
        g, n_tiles = short_tile_plan(m, l, s)
        tiles0 = len(range(0, n_tiles, min(n_tiles, n_sm)))
        total = sum(clocks[i] for i in range(len(PHASES)))
        print(f"short_encoder_tc_kernel, (L, S) = ({l}, {s}), M {m}: {g} sequences a tile, {n_tiles} tiles; "
              f"block 0 took {tiles0} of them in {total} cycles ({total // tiles0} a tile)")
        for i, name in enumerate(PHASES):
            print(f"  {clocks[i]:10d} cycles  {100 * clocks[i] / total:5.1f} %  {name}")
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(10):
                fused_short_encoder_layer_packed(x, src, packed)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type.name == "CUDA" and e.device_time_total > 0:
                print(f"  {e.device_time_total / 1e4:.4f} ms a call (10 calls)  {e.key[:80]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
