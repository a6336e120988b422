#!/usr/bin/env python3
"""Time K3-K7 of one checkout of the port, for A/B runs on one card.

    python3 scripts/torch_kernel_ab.py [--tree DIR] [--k1] [--k2] [--k5]    # needs one CUDA GPU and nvcc

Imports ``onepose_plus_plus_tpu_torch`` from DIR (default: the checkout this
script lies in), builds its kernels there, and times, on inputs made from a
seed: K3 (``window_gather``) at the query step's shape ([16, 256, 256, C]
map, 512 windows of 5 x 5 a frame) in bf16 at C = 128, 196, 130 and 33 and
in f32 at C = 130 and 33, and at the train shape in f32 (C = 128,
[4, 256, 256, 128], 1228 windows); K4 (``window_scatter``) at the train shape
([4, 1228, 25, C] onto [4, 256, 256, C]) in f32 at C = 128, 130 and 33 and in
bf16 at C = 196, 130 and 33; K5 (``coarse_focal_sums``, forward and
backward) at the train shapes [4, 7000] x [4, 4096] x 256 bf16, K6 at each
of its instances (below) and K7 (``fused_short_encoder_layer``) with bf16
operands at [8192, 25, 128] self. For each: the whole call (median of 20
CUDA-event timings, K5 10) and the device time a launch of the kernel itself
(torch.profiler, by kernel name; K5's feature-gradient kernel). K3 and K4
also give every launch of a call by name (K4's index launch and its sum
apart), the host time a call (200 calls queued), the one PyTorch call that
computes the same function (``index_select`` on precomputed indices;
``zero_`` + ``index_add_`` on precomputed rows) and the bytes bound (3.35
TB/s); where the tree's kernel library exports ``opp_window_span``, K3's
128-channel shapes also run through that entry, K3's span copy, called
directly ("span" keys). K6 runs at the pixels
that took its 16-, 8-, 4- and 2-byte vector instances before the span copy:
the SfM refine through ``gather_windows`` ([8, 256, 256, 128] bf16, 1024
int32 centres, W 9), the sparse FPN's pin map ([16, 256, 256, 196] bf16, 512
int64 corners) and [16, 256, 256, C] maps at bf16 C = 130 and 33 and f32
C = 33 (512 int32 corners); each also with the device time of every launch of
the call, the host time a call, ``index_select`` on precomputed indices and
the bytes bound. Last, the host time of reading the current stream's handle
(``torch.cuda.current_stream().cuda_stream``, and ``kernels.stream_ptr``
where the tree has it), which every wrapper does once a call. The flags
``--k1``, ``--k2`` and ``--k5`` (any of them, together in that order) time
only those kernels instead. ``--k1``:
K1 (``fused_encoder_layer``) with bf16 and with f32 operands at self
[4, 4096, C] for (C, heads) = (512, 8), (1024, 8), (2048, 16), (512, 64), (64, 8),
(96, 8) and (160, 8), at x [2, 150] against source [2, 97] with masks at
(128, 16) and (384, 16) (head widths 8 and 24), and at x [4, 1000] against
source [4, 700] at (64, 8), and at (256, 8) at self [16, 7000] and the four
layer shapes of a tracking frame (batch 1: self 7000, self 4096, 7000 against
4096, 4096 against 7000), the weights packed once as a model packs them
(``pack_encoder_weights``): whole call (median of 5), device time a call of
every launch by name (templated kernels by instance, ``tcw32_gemm_kernel<2>``),
and the instance the tree routes to where it names one (a tree from before the
tensor-core chains took a width runs it on its CUDA-core kernels, a fifth of a
second a call at 2048). ``--k2``:
K2 (``dual_softmax_rowcol_stats``) at [16, 7000] x [16, 4096] for C = 256, 640, 1024 and
2048 with bf16 and with f32 operands: whole call (median of 3), device time a call of every
launch by name, the instance the tree routes to where it names one (a tree from before the
wide instances runs these widths on its CUDA-core tile, over a second a call at 2048), and
the mean distance of row_lse to float64 at [2, 1000] x [2, 700] x 256 and 2048 beside the
plain version's. ``--k5``: K5 (``coarse_focal_sums``, forward and backward) with bf16
operands at the train shapes [4, 7000] x [4, 4096] for C = 256, 640, 1024, 2048 and 4096: whole call
(median of 3), device time a call of every launch by name (templated kernels by instance)
and the instance the tree routes to (a tree from before the wide tensor-core instance runs
these widths on its CUDA-core kernels, half a second a call at 4096). Prints one JSON line. Only entry points that every checkout
of the port has are called, so that two trees (an older commit unpacked
beside this one) can be run in turns in one session on one card: parent,
change, change, parent.
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
    parser.add_argument("--k1", action="store_true", help="time K1's bf16 and f32 layers (self [4, 4096, C], "
                        "(256, 8) at self [16, 7000] and a tracking frame's shapes, ...)")
    parser.add_argument("--k2", action="store_true", help="time K2 at [16, 7000] x [16, 4096] x C")
    parser.add_argument("--k5", action="store_true", help="time K5 forward + backward at [4, 7000] x [4, 4096] x C")
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
    lib = kernels.build()

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

    def launches_ms(fn, reps=10, templates=False):
        """({kernel name: device ms a launch}, device ms a call) of every launch
        fn makes, with the idle margins of device_ms; ``templates`` keeps a
        templated kernel's arguments in its name."""
        fn()
        for margin in (0.05, 0.25, 1.0, 3.0, 6.0):
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                time.sleep(margin)
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                time.sleep(margin)
            rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA" and e.device_time_total > 0]
            if rows:
                break
        if not rows:
            raise RuntimeError("the profiler saw no launch")
        named = {}
        for e in rows:
            m = re.search(r"(\w+(?:<[^(]*>)?)\(" if templates else r"(\w+)(?:<[^(]*>)?\(", e.key)
            named[m.group(1) if m else e.key[:40]] = e.device_time_total / 1e3 / e.count
        return named, sum(e.device_time_total for e in rows) / 1e3 / reps

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

    has_span = hasattr(lib.lib, "opp_window_span")

    def k3_span(feat, ids):
        """K3's span copy at any pixel, through its library entry."""
        n, h, w, c = feat.shape
        out = torch.empty((n, ids.shape[1], 25, c), dtype=feat.dtype, device=feat.device)
        lib.call("opp_window_span", kernels.ptr(feat), kernels.ptr(ids), kernels.ptr(out), n, h, w,
                 c * feat.element_size(), 64, 64, ids.shape[1], 4, 5, kernels.stream_ptr(feat.device))
        return out

    def window_taps(ids, h, w):
        """Flat map rows [N, K*25] of every tap of 5 x 5 windows at stride 4 and
        whether the tap lies on the map and its id in the 64 x 64 grid."""
        n = ids.shape[0]
        idl = ids.long()
        ok = (idl >= 0) & (idl < 64 * 64)
        offs = torch.arange(5, device="cuda") - 2
        rows = 4 * (idl // 64)[..., None] + offs
        cols = 4 * (idl % 64)[..., None] + offs
        valid = (ok[..., None, None] & ((rows >= 0) & (rows < h))[..., :, None]
                 & ((cols >= 0) & (cols < w))[..., None, :]).reshape(n, -1)
        flat = (rows.clamp(0, h - 1)[..., :, None] * w + cols.clamp(0, w - 1)[..., None, :]).reshape(n, -1)
        return flat + h * w * torch.arange(n, device="cuda")[:, None], valid

    def k3_instance(feat, ids):
        """K3's numbers at one map: the tree's routing, and its span copy at
        pixels the 16-byte instance takes where the tree has one."""
        n, h, w, c = feat.shape
        flat, valid = window_taps(ids, h, w)
        table = torch.cat([feat.reshape(n * h * w, c), feat.new_zeros(1, c)])
        idx = torch.where(valid, flat, torch.full_like(flat, n * h * w)).reshape(-1)
        size = c * feat.element_size()
        n_bytes = idx.numel() * size + torch.unique(flat[valid]).numel() * size + ids.numel() * 4
        bound_ms = 1e3 * n_bytes / 3.35e12
        rec = {"bound_ms": bound_ms, "index_select_ms": whole_ms(lambda: torch.index_select(table, 0, idx))}
        calls = {"": lambda: window_gather(feat, ids, (64, 64), 4, 5)}
        if has_span and size % 16 == 0:
            calls["span_"] = lambda: k3_span(feat, ids)
        for tag, call in calls.items():
            named, dev = launches_ms(call)
            rec.update({f"{tag}whole_ms": whole_ms(call), f"{tag}device_ms": dev, f"{tag}launches": named,
                        f"{tag}host_us": host_us(call), f"{tag}bound_share_device": bound_ms / dev})
        return rec

    def k4_instance(grad, sids):
        """K4's numbers at one gradient (onto [N, 256, 256, C]), as k3_instance:
        every launch of a call by name (the index launch and the sum)."""
        n, k, _, c = grad.shape
        flat, valid = window_taps(sids, 256, 256)
        rows, src = flat[valid], grad.reshape(n, k * 25, c)[valid]
        acc = torch.zeros(n * 256 * 256, c, dtype=grad.dtype, device="cuda")
        # the valid taps read, ids, order and cell_start, the map written
        n_bytes = (src.numel() + n * 256 * 256 * c) * grad.element_size() + 4 * (2 * n * k + n * (64 * 64 + 1))
        bound_ms = 1e3 * n_bytes / 3.35e12
        rec = {"bound_ms": bound_ms, "zero_index_add_ms": whole_ms(lambda: acc.zero_().index_add_(0, rows, src))}
        call = lambda: window_scatter(grad, sids, (64, 64), 4, 5, (256, 256))  # noqa: E731
        named, dev = launches_ms(call)
        rec.update({"whole_ms": whole_ms(call), "device_ms": dev, "launches": named, "host_us": host_us(call),
                    "bound_share_device": bound_ms / dev})
        return rec

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    rec = {}
    if args.k1:
        from onepose_plus_plus_tpu_torch.ops import cuda_encoder

        torch.backends.cuda.matmul.allow_tf32 = False
        # (tag, n, l, s (None: self), masks, C, heads)
        cases = [("self_4x4096", 4, 4096, None, False, c, nhead)
                 for c, nhead in ((512, 8), (1024, 8), (2048, 16), (512, 64), (64, 8), (96, 8), (160, 8))]
        cases += [("x2x150_src97_masked", 2, 150, 97, True, c, nhead) for c, nhead in ((128, 16), (384, 16))]
        cases += [("x4x1000_src700", 4, 1000, 700, False, 64, 8)]
        # (256, 8): the main path's self shape, and a tracking frame's four layer shapes at batch 1
        cases += [("self_16x7000", 16, 7000, None, False, 256, 8), ("self_1x7000", 1, 7000, None, False, 256, 8),
                  ("self_1x4096", 1, 4096, None, False, 256, 8), ("x1x7000_src4096", 1, 7000, 4096, False, 256, 8),
                  ("x1x4096_src7000", 1, 4096, 7000, False, 256, 8)]
        for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            for tag, n, l, s, masked, c, nhead in cases:
                rn = lambda *shape, scale=1.0: torch.randn(*shape, generator=gen, device="cuda") * scale  # noqa: E731
                w = [rn(c, c, scale=c ** -0.5).to(dtype) for _ in range(4)]
                w += [1 + rn(c, scale=0.1), rn(c, scale=0.1), rn(2 * c, 2 * c, scale=(2 * c) ** -0.5).to(dtype),
                      rn(2 * c, c, scale=(2 * c) ** -0.5).to(dtype), 1 + rn(c, scale=0.1), rn(c, scale=0.1)]
                x = rn(n, l, c)
                src = x if s is None else rn(n, s, c)
                masks = [(torch.rand(n, k, generator=gen, device="cuda") < 0.8).float() if masked else None
                         for k in (l, src.shape[1])]
                packed = cuda_encoder.pack_encoder_weights(*w, nhead=nhead, dtype=dtype)
                call = lambda: cuda_encoder.fused_encoder_layer_packed(x, src, packed, *masks)  # noqa: E731
                named, dev = launches_ms(call, reps=3, templates=True)
                instance = getattr(cuda_encoder, "k1_instance", lambda *a: None)(c, nhead, dtype)
                rec[f"K1_{dt}_{tag}_c{c}_h{nhead}"] = {"whole_ms": whole_ms(call, reps=5), "device_ms": dev,
                                                       "launches": named, "instance": instance}
                del x, src
                torch.cuda.empty_cache()
    if args.k2:
        from onepose_plus_plus_tpu_torch.ops import cuda_matching

        torch.backends.cuda.matmul.allow_tf32 = False
        for c in (256, 640, 1024, 2048):
            f0 = torch.randn(16, 7000, c, generator=gen, device="cuda")
            f1 = torch.randn(16, 4096, c, generator=gen, device="cuda")
            for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
                call = lambda: cuda_matching.dual_softmax_rowcol_stats(f0, f1, 0.08, dtype=dtype)  # noqa: E731
                named, dev = launches_ms(call, reps=2)
                instance = getattr(cuda_matching, "k2_instance", lambda *a: None)(c, dtype)
                rec[f"K2_{dt}_16x7000x4096_c{c}"] = {"whole_ms": whole_ms(call, reps=3), "device_ms": dev,
                                                     "launches": named, "instance": instance}
            del f0, f1
            torch.cuda.empty_cache()
        inv_temp = 1 / (0.08 + 1e-4)
        for c in (256, 2048):
            f0 = torch.randn(2, 1000, c, generator=gen, device="cuda")
            f1 = torch.randn(2, 700, c, generator=gen, device="cuda")
            for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
                a0, a1 = (f0 * c ** -0.5).to(dtype), (f1 * c ** -0.5).to(dtype)
                lse64 = torch.logsumexp(torch.einsum("bpc,blc->bpl", a0.double(), a1.double()) * inv_temp, dim=2)
                got = cuda_matching.dual_softmax_rowcol_stats(f0, f1, 0.08, dtype=dtype)["row_lse"]
                ref = cuda_matching.rowcol_stats_plain(a0, a1, inv_temp)["row_lse"]
                rec[f"K2_{dt}_2x1000x700_c{c}_row_lse_to_float64"] = {
                    "kernel": (got.double() - lse64).abs().mean().item(),
                    "plain": (ref.double() - lse64).abs().mean().item()}
    if args.k5:
        from onepose_plus_plus_tpu_torch.ops import cuda_coarse_loss

        for c in (256, 640, 1024, 2048, 4096):
            f0 = (torch.randn(4, 7000, c, generator=gen, device="cuda") / c ** 0.5).to(torch.bfloat16)
            f1 = (torch.randn(4, 4096, c, generator=gen, device="cuda") / c ** 0.5).to(torch.bfloat16)
            gt = torch.randint(-1, 4096, (4, 7000), generator=gen, device="cuda", dtype=torch.int32)

            def call():
                a0, a1 = f0.clone().requires_grad_(), f1.clone().requires_grad_()
                pos, neg, _ = cuda_coarse_loss.coarse_focal_sums(a0, a1, gt, 1 / 0.0801, 0.5, 2.0)
                (pos * 1e-4 + neg * 1e-8).backward()

            named, dev = launches_ms(call, reps=2, templates=True)
            rec[f"K5_bf16_4x7000x4096_c{c}"] = {"whole_ms": whole_ms(call, reps=3), "device_ms": dev,
                                                "launches": named,
                                                "instance": cuda_coarse_loss.k5_instance(c)}
            del f0, f1
            torch.cuda.empty_cache()
    if rec:
        print(json.dumps({"tree": str(tree), "gpu": smi, **rec}))
        return 0
    gathers = {}
    for tag, dtype, c, n, k in (("K3_bf16_query", torch.bfloat16, 128, 16, 512),
                                ("K3_f32_train", torch.float32, 128, 4, 1228),
                                ("K3_bf16_c196", torch.bfloat16, 196, 16, 512),
                                ("K3_bf16_c130", torch.bfloat16, 130, 16, 512),
                                ("K3_bf16_c33", torch.bfloat16, 33, 16, 512),
                                ("K3_f32_c130", torch.float32, 130, 16, 512),
                                ("K3_f32_c33", torch.float32, 33, 16, 512)):
        fmap = torch.randn(n, 256, 256, c, generator=gen, device="cuda").to(dtype)
        wids = torch.randint(0, 64 * 64, (n, k), generator=gen, device="cuda", dtype=torch.int32)
        wids[:, :8] = torch.tensor([-1, -7, 4096, 5000, 0, 63, 4032, 4095], dtype=torch.int32)
        gathers[tag] = k3_instance(fmap, wids)
        del fmap
    for tag, dtype, c in (("K4_f32_train", torch.float32, 128), ("K4_f32_c130", torch.float32, 130),
                          ("K4_f32_c33", torch.float32, 33), ("K4_bf16_c196", torch.bfloat16, 196),
                          ("K4_bf16_c130", torch.bfloat16, 130), ("K4_bf16_c33", torch.bfloat16, 33)):
        g4 = torch.randn(4, 1228, 25, c, generator=gen, device="cuda").to(dtype)
        s4 = torch.randint(0, 64 * 64, (4, 1228), generator=gen, device="cuda", dtype=torch.int32)
        s4[:, 1028:] = s4[:, :200]  # GT slots repeating predicted cells
        s4[:, 1000:1028] = -1  # unfilled prediction slots
        gathers[tag] = k4_instance(g4, s4)
        del g4
    torch.cuda.empty_cache()
    c = 128
    rn = lambda *shape, scale=1.0: torch.randn(*shape, generator=gen, device="cuda") * scale  # noqa: E731
    w = [rn(c, c, scale=c ** -0.5) for _ in range(4)] + [1 + rn(c, scale=0.1), rn(c, scale=0.1),
                                                         rn(2 * c, 2 * c, scale=(2 * c) ** -0.5),
                                                         rn(2 * c, c, scale=(2 * c) ** -0.5),
                                                         1 + rn(c, scale=0.1), rn(c, scale=0.1)]
    x = rn(8192, 25, c)
    k7 = lambda: fused_short_encoder_layer(x, x, *w, nhead=8, dtype=torch.bfloat16)  # noqa: E731
    f0 = (torch.randn(4, 7000, 256, generator=gen, device="cuda") / 16).to(torch.bfloat16)
    f1 = (torch.randn(4, 4096, 256, generator=gen, device="cuda") / 16).to(torch.bfloat16)
    gt = torch.randint(-1, 4096, (4, 7000), generator=gen, device="cuda", dtype=torch.int32)

    def k5():
        a0, a1 = f0.clone().requires_grad_(), f1.clone().requires_grad_()
        pos, neg, _ = coarse_focal_sums(a0, a1, gt, 1 / 0.0801, 0.5, 2.0)
        (pos * 1e-4 + neg * 1e-8).backward()

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
    dev = fmap.device
    del fmap
    stream_us = {"current_stream().cuda_stream": host_us(lambda: torch.cuda.current_stream(dev).cuda_stream),
                 "kernels.stream_ptr": host_us(lambda: kernels.stream_ptr(dev))}
    print(json.dumps({
        "tree": str(tree), "gpu": smi,
        **gathers,
        "K5_bf16_train_fwd_bwd": {"whole_ms": whole_ms(k5, reps=10), "device_ms": k5_dev, "kernels": k5_names},
        **k6,
        "K7_bf16_8192x25_self": {"whole_ms": whole_ms(k7), "device_ms": k7_dev, "kernels": k7_names},
        "stream_handle_host_us": stream_us,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
