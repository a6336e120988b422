#!/usr/bin/env python3
"""Time K3 and K7 of one checkout of the port, for A/B runs on one card.

    python3 scripts/torch_kernel_ab.py [--tree DIR]    # needs one CUDA GPU and nvcc

Imports ``onepose_plus_plus_tpu_torch`` from DIR (default: the checkout this
script lies in), builds its kernels there, and times, on inputs made from a
seed: K3 (``window_gather``) at the query step's shape ([16, 256, 256, 128]
bf16 map, 512 windows of 5 x 5 a frame) and K7 (``fused_short_encoder_layer``)
with bf16 operands at [8192, 25, 128] self. For each: the whole call (median
of 20 CUDA-event timings) and the device time a launch of the kernel itself
(torch.profiler, by kernel name). Prints one JSON line. Only entry points
that every checkout of the port has are called, so that two trees (an older
commit unpacked beside this one) can be run in turns in one session on one
card: parent, change, change, parent.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent))
    args = parser.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    from onepose_plus_plus_tpu_torch import kernels
    from onepose_plus_plus_tpu_torch.ops.cuda_gather import window_gather
    from onepose_plus_plus_tpu_torch.ops.cuda_short_encoder import fused_short_encoder_layer

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA GPU")
    if not kernels.__file__.startswith(str(tree)):
        raise RuntimeError(f"imported the port from {kernels.__file__}, not from {tree}")
    kernels.build()

    def whole_ms(fn, reps=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    def device_ms(fn, name, reps=10):
        """Device ms a launch of the kernels whose name holds `name`."""
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA" and name in e.key]
        if not rows:
            raise RuntimeError(f"the profiler saw no launch of {name}")
        names = {m.group(1) for e in rows for m in [re.search(r"(\w+)(?:<[^(]*>)?\(", e.key)] if m}
        return sum(e.device_time_total for e in rows) / 1e3 / sum(e.count for e in rows), sorted(names)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    feat = torch.randn(16, 256, 256, 128, generator=gen, device="cuda").to(torch.bfloat16)
    ids = torch.randint(0, 64 * 64, (16, 512), generator=gen, device="cuda", dtype=torch.int32)
    k3 = lambda: window_gather(feat, ids, (64, 64), 4, 5)  # noqa: E731
    c = 128
    rn = lambda *shape, scale=1.0: torch.randn(*shape, generator=gen, device="cuda") * scale  # noqa: E731
    w = [rn(c, c, scale=c ** -0.5) for _ in range(4)] + [1 + rn(c, scale=0.1), rn(c, scale=0.1),
                                                         rn(2 * c, 2 * c, scale=(2 * c) ** -0.5),
                                                         rn(2 * c, c, scale=(2 * c) ** -0.5),
                                                         1 + rn(c, scale=0.1), rn(c, scale=0.1)]
    x = rn(8192, 25, c)
    k7 = lambda: fused_short_encoder_layer(x, x, *w, nhead=8, dtype=torch.bfloat16)  # noqa: E731
    k3_dev, k3_names = device_ms(k3, "window_gather")
    k7_dev, k7_names = device_ms(k7, "short_encoder")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "tree": str(tree), "gpu": smi,
        "K3_bf16_query": {"whole_ms": whole_ms(k3), "device_ms": k3_dev, "kernels": k3_names},
        "K7_bf16_8192x25_self": {"whole_ms": whole_ms(k7), "device_ms": k7_dev, "kernels": k7_names},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
