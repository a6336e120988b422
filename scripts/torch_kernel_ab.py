#!/usr/bin/env python3
"""Time K3-K7 of one checkout of the port, for A/B runs on one card.

    python3 scripts/torch_kernel_ab.py [--tree DIR]    # needs one CUDA GPU and nvcc

Imports ``onepose_plus_plus_tpu_torch`` from DIR (default: the checkout this
script lies in), builds its kernels there, and times, on inputs made from a
seed: K3 (``window_gather``) at the query step's shape ([16, 256, 256, 128]
bf16 map, 512 windows of 5 x 5 a frame), K4 (``window_scatter``) at the train
shape (f32 [4, 1228, 25, 128] onto [4, 256, 256, 128]), K5
(``coarse_focal_sums``, forward and backward) at the train shapes
[4, 7000] x [4, 4096] x 256 bf16, K6 at each of its instances (below) and
K7 (``fused_short_encoder_layer``) with bf16 operands at [8192, 25, 128] self.
For each: the whole call (median of 20 CUDA-event timings, K5 10) and the
device time a launch of the kernel itself (torch.profiler, by kernel name;
K5's feature-gradient kernel). K6 runs at the pixels that took its 16-, 8-,
4- and 2-byte vector instances before the span copy: the SfM refine through
``gather_windows`` ([8, 256, 256, 128] bf16, 1024 int32 centres, W 9), the
sparse FPN's pin map ([16, 256, 256, 196] bf16, 512 int64 corners) and
[16, 256, 256, C] maps at bf16 C = 130 and 33 and f32 C = 33 (512 int32
corners); each also with the device time of every launch of the call, the
host time a call (200 calls queued), ``index_select`` on precomputed indices
and the bytes bound (3.35 TB/s). Prints one JSON line. Only entry points
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
import time
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
    from onepose_plus_plus_tpu_torch.ops.cuda_coarse_loss import coarse_focal_sums
    from onepose_plus_plus_tpu_torch.ops.cuda_gather import window_gather, window_scatter
    from onepose_plus_plus_tpu_torch.ops.cuda_patch_gather import patch_gather
    from onepose_plus_plus_tpu_torch.ops.cuda_short_encoder import fused_short_encoder_layer
    from onepose_plus_plus_tpu_torch.ops.window_gather import gather_windows

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
        """(device ms a launch of the kernels whose name holds `name`, their
        names, device ms a call of every launch the call makes); a session
        that kept no such launch, which torch.profiler returns now and then (it
        keeps only the device events it maps inside the session, and that map
        can be off by milliseconds), is profiled again with wider idle margins
        around the calls, up to five times."""
        fn()
        for margin in (0.05, 0.25, 1.0, 3.0, 6.0):
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                time.sleep(margin)
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                time.sleep(margin)
            rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA" and name in e.key]
            if rows:
                break
        if not rows:
            raise RuntimeError(f"the profiler saw no launch of {name}")
        names = {m.group(1) for e in rows for m in [re.search(r"(\w+)(?:<[^(]*>)?\(", e.key)] if m}
        every = sum(e.device_time_total for e in prof.key_averages() if e.device_type.name == "CUDA")
        return sum(e.device_time_total for e in rows) / 1e3 / sum(e.count for e in rows), sorted(names), every / 1e3 / reps

    def host_us(fn, calls=200):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us = 1e6 * (time.perf_counter() - t0) / calls
        torch.cuda.synchronize()
        return us

    def k6_instance(feat, r0, c0, call, index_bytes):
        """K6's numbers at one instance; r0, c0 the corners the call gathers at (W 9)."""
        n, h, w, c = feat.shape
        offs = torch.arange(9, device="cuda")
        rows, cols = r0[..., None] + offs, c0[..., None] + offs
        valid = ((rows >= 0) & (rows < h))[..., :, None] & ((cols >= 0) & (cols < w))[..., None, :]
        flat = rows.clamp(0, h - 1)[..., :, None] * w + cols.clamp(0, w - 1)[..., None, :]
        flat = flat.reshape(n, -1) + h * w * torch.arange(n, device="cuda")[:, None]
        valid = valid.reshape(n, -1)
        table = torch.cat([feat.reshape(n * h * w, c), feat.new_zeros(1, c)])
        idx = torch.where(valid, flat, torch.full_like(flat, n * h * w)).reshape(-1)
        size = c * feat.element_size()
        n_bytes = idx.numel() * size + torch.unique(flat[valid]).numel() * size + index_bytes
        bound_ms = 1e3 * n_bytes / 3.35e12
        dev, names, every = device_ms(call, "patch_gather")
        return {"whole_ms": whole_ms(call), "device_ms": dev, "device_ms_every_launch": every,
                "host_us": host_us(call), "index_select_ms": whole_ms(lambda: torch.index_select(table, 0, idx)),
                "bound_ms": bound_ms, "bound_share_device": bound_ms / dev, "kernels": names}

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
    grad = torch.randn(4, 1228, 25, 128, generator=gen, device="cuda")
    sids = torch.randint(0, 64 * 64, (4, 1228), generator=gen, device="cuda", dtype=torch.int32)
    sids[:, 1028:] = sids[:, :200]
    k4 = lambda: window_scatter(grad, sids, (64, 64), 4, 5, (256, 256))  # noqa: E731
    f0 = (torch.randn(4, 7000, 256, generator=gen, device="cuda") / 16).to(torch.bfloat16)
    f1 = (torch.randn(4, 4096, 256, generator=gen, device="cuda") / 16).to(torch.bfloat16)
    gt = torch.randint(-1, 4096, (4, 7000), generator=gen, device="cuda", dtype=torch.int32)

    def k5():
        a0, a1 = f0.clone().requires_grad_(), f1.clone().requires_grad_()
        pos, neg, _ = coarse_focal_sums(a0, a1, gt, 1 / 0.0801, 0.5, 2.0)
        (pos * 1e-4 + neg * 1e-8).backward()

    k3_dev, k3_names, _ = device_ms(k3, "window_gather")
    k4_dev, k4_names, _ = device_ms(k4, "window_scatter")
    k5_dev, k5_names, _ = device_ms(k5, "dfeat")
    k7_dev, k7_names, _ = device_ms(k7, "short_encoder")
    k6 = {}
    fmap = torch.randn(8, 256, 256, 128, generator=gen, device="cuda").to(torch.bfloat16)
    r0 = torch.randint(-13, 260, (8, 1024), generator=gen, device="cuda")
    c0 = torch.randint(-13, 260, (8, 1024), generator=gen, device="cuda")
    r0[:, -16:] = -90  # invalid slots
    centres = (torch.stack([r0, c0], -1) + 4).int()  # as the LoFTR refine hands them
    k6["K6_bf16_refine_16B"] = k6_instance(fmap, r0, c0, lambda: gather_windows(fmap, centres, 9),
                                           centres.numel() * 4)
    for tag, dtype, c, corner in (("K6_bf16_c196_sparse_8B", torch.bfloat16, 196, torch.int64),
                                  ("K6_bf16_c130_4B", torch.bfloat16, 130, torch.int32),
                                  ("K6_f32_c33_4B", torch.float32, 33, torch.int32),
                                  ("K6_bf16_c33_2B", torch.bfloat16, 33, torch.int32)):
        fmap = torch.randn(16, 256, 256, c, generator=gen, device="cuda").to(dtype)
        r0 = torch.randint(-13, 260, (16, 512), generator=gen, device="cuda").to(corner)
        c0 = torch.randint(-13, 260, (16, 512), generator=gen, device="cuda").to(corner)
        r0[:, -16:] = -90
        k6[tag] = k6_instance(fmap, r0, c0, lambda: patch_gather(fmap, r0, c0, 9), 2 * r0.numel() * r0.element_size())
    del fmap
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "tree": str(tree), "gpu": smi,
        "K3_bf16_query": {"whole_ms": whole_ms(k3), "device_ms": k3_dev, "kernels": k3_names},
        "K4_f32_train": {"whole_ms": whole_ms(k4), "device_ms": k4_dev, "kernels": k4_names},
        "K5_bf16_train_fwd_bwd": {"whole_ms": whole_ms(k5, reps=10), "device_ms": k5_dev, "kernels": k5_names},
        **k6,
        "K7_bf16_8192x25_self": {"whole_ms": whole_ms(k7), "device_ms": k7_dev, "kernels": k7_names},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
