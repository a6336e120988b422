#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``onepose_plus_plus_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py    # needs one CUDA GPU

Phases, all run every time (each prints its own lines; any failure raises and
exits non-zero):
  0  device: GPU name and power limit, torch and CUDA versions
  1  build the CUDA kernels from csrc/ (nvcc, -Xptxas -v report)
  2  each kernel against its plain PyTorch version at main-path shapes
     (batch 16), f32 and bf16, with CUDA-event medians over 20 runs
  3  the query-pose forward in f32 on the GPU (kernels) against the same
     forward on the CPU (plain versions): full-width default config, 2 frames
     of 512^2, a 7000-point cloud, 512 match slots, thr 0
  4  batched RANSAC-PnP on the GPU: 16 frames, 512 noisy correspondences each
  5  run_inference at the bench configuration (bf16, 512 slots, 48 frames of
     512^2, frame_batch 16, 7000 points, GT poses): launch counts of every
     kernel, finite poses, poses/s and peak memory
  6  where the time goes in one bf16 step of phase 5 (16 frames): step wall,
     model forward, device time per kernel (torch.profiler), idle share

The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. Weights are random, drawn from a numpy seed.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from onepose_plus_plus_tpu_torch import kernels
from onepose_plus_plus_tpu_torch.config import CoarseMatchingConfig, OnePosePlusConfig
from onepose_plus_plus_tpu_torch.eval.metrics import batched_pose_errors
from onepose_plus_plus_tpu_torch.geometry.pnp import ransac_pnp
from onepose_plus_plus_tpu_torch.inference.pipeline import make_query_step, run_inference
from onepose_plus_plus_tpu_torch.models.onepose_plus import OnePosePlusModel
from onepose_plus_plus_tpu_torch.ops.cuda_encoder import encoder_layer_plain, fused_encoder_layer
from onepose_plus_plus_tpu_torch.ops.cuda_gather import window_gather, window_gather_plain
from onepose_plus_plus_tpu_torch.ops.cuda_matching import (
    dual_softmax_rowcol_stats,
    rowcol_stats_plain,
)
from onepose_plus_plus_tpu_torch.utils.weights import random_state_dict

B = 16  # frames per batch in the kernel phases
KERNELS = {
    "K1_encoder_layer": {
        "source": "onepose_plus_plus_tpu_torch/csrc/encoder.cu",
        "replaces": "onepose_plus_plus_tpu/ops/pallas_encoder.py:155",
    },
    "K2_rowcol_stats": {
        "source": "onepose_plus_plus_tpu_torch/csrc/matching.cu",
        "replaces": "onepose_plus_plus_tpu/ops/pallas_matching.py:211",
    },
    "K3_window_gather": {
        "source": "onepose_plus_plus_tpu_torch/csrc/gather.cu",
        "replaces": "onepose_plus_plus_tpu/ops/pallas_gather.py:169",
    },
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of fn() in ms."""
    for _ in range(warmup):
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


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("  TF32 off for matmuls and cuDNN convolutions (full f32 parity)")


# --------------------------------------------------------------- phase 0-1


def phase0() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: chip_smoke needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    log(f"[0] gpu: {smi}")
    log(f"[0] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


def phase1() -> None:
    lib = kernels.build(verbose=True)
    log(f"[1] built {lib.path.name} in {lib.build_seconds:.2f} s")
    for line in lib.compiler_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log(f"[1]   {line.strip()}")


# ----------------------------------------------------------------- phase 2


def _encoder_inputs(gen, l, s, c=256):
    dev = "cuda"
    rn = lambda *shape, scale=1.0: torch.randn(*shape, generator=gen, device=dev) * scale  # noqa: E731
    x = rn(B, l, c)
    src = x if s is None else rn(B, s, c)
    w = dict(
        wq=rn(c, c, scale=c ** -0.5), wk=rn(c, c, scale=c ** -0.5), wv=rn(c, c, scale=c ** -0.5),
        wmerge=rn(c, c, scale=c ** -0.5), ln1_scale=1 + rn(c, scale=0.1), ln1_bias=rn(c, scale=0.1),
        wmlp0=rn(2 * c, 2 * c, scale=(2 * c) ** -0.5), wmlp1=rn(2 * c, c, scale=(2 * c) ** -0.5),
        ln2_scale=1 + rn(c, scale=0.1), ln2_bias=rn(c, scale=0.1),
    )
    return x, src, w


def _bf16(t):
    return t.to(torch.bfloat16)


def phase2_k1(gen) -> dict:
    worst, rec = 0.0, {}
    for tag, l, s in (("cross", 4096, 7000), ("self", 7000, None)):
        x, src, w = _encoder_inputs(gen, l, s)
        got = fused_encoder_layer(x, src, **w, nhead=8)
        ref = encoder_layer_plain(x, src, **w, nhead=8)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        log(f"[2] K1 {tag} f32  x{tuple(x.shape)} src{tuple(src.shape)}: max|d| {err:.3e} (<= 1e-3)")
        check(err <= 1e-3, f"K1 {tag} f32 disagrees: {err}")
        worst = max(worst, err)
        # bf16 product operands; x and source stay f32, as on the main path
        wb = {k: (_bf16(v) if v.dim() == 2 else v) for k, v in w.items()}
        got = fused_encoder_layer(x, src, **wb, nhead=8, dtype=torch.bfloat16)
        ref = encoder_layer_plain(x, src, **wb, nhead=8, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        d = (got - ref).abs()
        log(f"[2] K1 {tag} bf16 operands: max|d| {d.max().item():.3e} (<= 5e-2), "
            f"mean|d| {d.mean().item():.3e} (<= 5e-3)")
        check(d.max().item() <= 5e-2 and d.mean().item() <= 5e-3, f"K1 {tag} bf16 disagrees")
        for dt, dtype, ws in (("f32", torch.float32, w), ("bf16", torch.bfloat16, wb)):
            ms = time_ms(lambda: fused_encoder_layer(x, src, **ws, nhead=8, dtype=dtype))
            pms = time_ms(lambda: encoder_layer_plain(x, src, **ws, nhead=8, dtype=dtype))
            log(f"[2] K1 {tag} {dt}: kernel {ms:.3f} ms, plain {pms:.3f} ms (median of 20)")
            rec[f"{tag}_{dt}"] = (ms, pms)
    ms, pms = rec["self_bf16"]
    return {"max_abs_err": worst, "ms": ms, "plain_ms": pms}


def phase2_k2(gen) -> dict:
    f0 = torch.randn(B, 7000, 256, generator=gen, device="cuda")
    f1 = torch.randn(B, 4096, 256, generator=gen, device="cuda")
    worst, rec = 0.0, {}
    for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        got = dual_softmax_rowcol_stats(f0, f1, 0.08, dtype=dtype)
        a0 = (f0 / 16.0).to(dtype)
        a1 = (f1 / 16.0).to(dtype)
        ref = rowcol_stats_plain(a0, a1, 1.0 / (0.08 + 1e-4))
        torch.cuda.synchronize()
        lse = max((got[k] - ref[k]).abs().max().item() for k in ("row_lse", "col_lse"))
        row_ag = (got["row_best_j"] == ref["row_best_j"]).float().mean().item()
        col_ag = (got["col_best_p"] == ref["col_best_p"]).float().mean().item()
        log(f"[2] K2 {dt} f0{tuple(f0.shape)} f1{tuple(f1.shape)}: LSE max|d| {lse:.3e} (<= 1e-3), "
            f"row argmax agree {row_ag:.6f}, col argmax agree {col_ag:.6f} (>= 0.999)")
        check(lse <= 1e-3 and row_ag >= 0.999 and col_ag >= 0.999, f"K2 {dt} disagrees")
        if dt == "f32":
            worst = lse
        ms = time_ms(lambda: dual_softmax_rowcol_stats(f0, f1, 0.08, dtype=dtype))
        pms = time_ms(lambda: rowcol_stats_plain(a0, a1, 1.0 / (0.08 + 1e-4)))
        log(f"[2] K2 {dt}: kernel {ms:.3f} ms, plain {pms:.3f} ms (median of 20)")
        rec[dt] = (ms, pms)
        del got, ref
    ms, pms = rec["bf16"]
    return {"max_abs_err": worst, "ms": ms, "plain_ms": pms}


def phase2_k3(gen) -> dict:
    feat = torch.randn(B, 256, 256, 128, generator=gen, device="cuda")
    ids = torch.randint(0, 64 * 64, (B, 512), generator=gen, device="cuda", dtype=torch.int32)
    ids[:, :8] = torch.tensor([-1, -7, 4096, 5000, 0, 63, 4032, 4095], dtype=torch.int32)
    rec = {}
    for dt, f in (("f32", feat), ("bf16", feat.to(torch.bfloat16))):
        got = window_gather(f, ids, (64, 64), 4, 5)
        ref = window_gather_plain(f, ids, (64, 64), 4, 5)
        torch.cuda.synchronize()
        check(got.shape == (B, 512, 25, 128), f"K3 shape {tuple(got.shape)}")
        equal = torch.equal(got, ref)
        log(f"[2] K3 {dt} feat{tuple(f.shape)} -> {tuple(got.shape)}: exact {equal}, "
            f"zero windows for out-of-range ids {bool((got[:, :4] == 0).all())}")
        check(equal and bool((got[:, :4] == 0).all()), f"K3 {dt} disagrees")
        ms = time_ms(lambda: window_gather(f, ids, (64, 64), 4, 5))
        pms = time_ms(lambda: window_gather_plain(f, ids, (64, 64), 4, 5))
        log(f"[2] K3 {dt}: kernel {ms:.3f} ms, plain {pms:.3f} ms (median of 20)")
        rec[dt] = (ms, pms)
    ms, pms = rec["bf16"]
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": pms}


# --------------------------------------------------------------- phase 3-5


def _scene(rng, n_views, n_pts, img=512.0):
    """Cameras on a ring looking at a point cloud near the origin."""
    K = np.array([[500.0, 0, img / 2], [0, 500.0, img / 2], [0, 0, 1.0]])
    pts = rng.uniform(-0.3, 0.3, (n_pts, 3))
    Ts = []
    for i in range(n_views):
        ang = 2 * np.pi * i / max(n_views, 8)
        center = np.array([2.0 * np.sin(ang), 0.3 * rng.standard_normal(), 2.0 * np.cos(ang)])
        z = -center / np.linalg.norm(center)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        T = np.eye(4)
        T[:3, :3] = np.stack([x, np.cross(z, x), z])
        T[:3, 3] = -T[:3, :3] @ center
        Ts.append(T)
    return K, pts, np.stack(Ts)


def _textured_images(rng, n, size=512):
    """Block-textured grayscale frames (random 16x16-pixel blocks plus noise)."""
    blocks = rng.random((n, size // 16, size // 16))
    img = np.kron(blocks, np.ones((1, 16, 16))) + 0.05 * rng.standard_normal((n, size, size))
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def _model(cfg, device):
    model = OnePosePlusModel(cfg)
    model.load_state_dict(random_state_dict(model, seed=0))
    return model.eval().to(device)


def phase3() -> None:
    no_tf32()
    rng = np.random.default_rng(3)
    cfg = OnePosePlusConfig(coarse_matching=CoarseMatchingConfig(thr=0.0, max_matches=512))
    batch = {
        "query_image": torch.from_numpy(_textured_images(rng, 2)[..., None]),
        "keypoints3d": torch.from_numpy(rng.uniform(-0.3, 0.3, (2, 7000, 3)).astype(np.float32)),
        "descriptors3d": torch.from_numpy(rng.standard_normal((2, 7000, 128)).astype(np.float32)),
        "descriptors3d_coarse": torch.from_numpy(rng.standard_normal((2, 7000, 256)).astype(np.float32)),
    }
    outs = {}
    for dev in ("cuda", "cpu"):
        model = _model(cfg, dev)
        t0 = time.perf_counter()
        out = model({k: v.to(dev) for k, v in batch.items()})
        if dev == "cuda":
            torch.cuda.synchronize()
        outs[dev] = {k: v.cpu() for k, v in out.items() if torch.is_tensor(v)}
        log(f"[3] f32 forward on {dev}: {time.perf_counter() - t0:.2f} s (first call)")
    g, c = outs["cuda"], outs["cpu"]
    for k in ("mkpts_query_f", "expec_f", "mconf", "mkpts_3d"):
        check(bool(torch.isfinite(g[k]).all()), f"non-finite {k} on the GPU")
    jacc, n_common, mk_err, mc_err = [], 0, 0.0, 0.0
    for f in range(2):
        def sets(o):
            m = o["match_mask"][f]
            pairs = list(zip(o["i_ids"][f][m].tolist(), o["j_ids"][f][m].tolist()))
            return {p: n for n, p in zip(torch.nonzero(m)[:, 0].tolist(), pairs)}
        sg, sc = sets(g), sets(c)
        common = set(sg) & set(sc)
        jacc.append(len(common) / max(len(set(sg) | set(sc)), 1))
        n_common += len(common)
        for p in common:
            mk_err = max(mk_err, (g["mkpts_query_f"][f, sg[p]] - c["mkpts_query_f"][f, sc[p]]).abs().max().item())
            mc_err = max(mc_err, abs(g["mconf"][f, sg[p]].item() - c["mconf"][f, sc[p]].item()))
    log(f"[3] GPU vs CPU: matches {[int(g['match_mask'][f].sum()) for f in range(2)]} vs "
        f"{[int(c['match_mask'][f].sum()) for f in range(2)]}, jaccard {[round(j, 4) for j in jacc]} (>= 0.98), "
        f"mkpts_query_f max|d| {mk_err:.3e} px (<= 1e-2), mconf max|d| {mc_err:.3e} (<= 1e-4), "
        f"{n_common} common matches")
    check(n_common > 0 and min(jacc) >= 0.98 and mk_err <= 1e-2 and mc_err <= 1e-4,
          "f32 slice on the GPU disagrees with the CPU")


def phase4() -> None:
    rng = np.random.default_rng(4)
    K, pts, Ts = _scene(rng, B, 7000)
    p3, p2 = [], []
    for T in Ts:
        idx = rng.choice(7000, 512, replace=False)
        pc = pts[idx] @ T[:3, :3].T + T[:3, 3]
        uv = pc[:, :2] / pc[:, 2:3] @ K[:2, :2].T + K[:2, 2]
        p3.append(pts[idx])
        p2.append(uv + rng.normal(0, 0.5, uv.shape))
    dev = "cuda"
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    res = ransac_pnp(t(p3), t(p2), t(np.tile(K, (B, 1, 1))), torch.ones(B, 512, dtype=torch.bool, device=dev), gen)
    poses = torch.eye(4, device=dev).repeat(B, 1, 1)
    poses[:, :3, :3], poses[:, :3, 3] = res.R, res.t
    r_err, t_err = batched_pose_errors(poses, t(Ts))
    log(f"[4] PnP on {B} frames x 512 correspondences: max R err {r_err.max().item():.4f} deg (< 1), "
        f"max t err {t_err.max().item():.4f} cm (< 2), ok {int(res.ok.sum())}/{B}")
    check(bool(res.ok.all()) and r_err.max().item() < 1.0 and t_err.max().item() < 2.0,
          "PnP on the GPU misses the GT poses")


def phase5(smi: str):
    rng = np.random.default_rng(5)
    n_frames = 48
    K, pts, Ts = _scene(rng, n_frames, 7000)
    imgs = (_textured_images(rng, n_frames) * 255).astype(np.uint8)
    frames = [{"image": imgs[i], "K": K.astype(np.float32), "pose_gt": Ts[i].astype(np.float32)}
              for i in range(n_frames)]
    anno = {
        "keypoints3d": pts.astype(np.float32),
        "descriptors3d": rng.standard_normal((7000, 128)).astype(np.float32),
        "descriptors3d_coarse": rng.standard_normal((7000, 256)).astype(np.float32),
    }
    cfg = OnePosePlusConfig(compute_dtype="bfloat16",
                            coarse_matching=CoarseMatchingConfig(thr=0.0, max_matches=512))
    model = _model(cfg, "cuda")
    run_inference(model, frames[:16], anno, shape3d=7000, frame_batch=16)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_inference(model, frames, anno, shape3d=7000, frame_batch=16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    steps = n_frames // 16
    expected = {"K1_encoder_layer": 12 * steps, "K2_rowcol_stats": steps, "K3_window_gather": steps}
    log(f"[5] launches in the main-path run: {counts} (expected {expected})")
    check(counts == expected, "a kernel of the main path was not launched as the step implies")
    check(res.poses.shape == (n_frames, 4, 4), f"poses {res.poses.shape}")
    check(bool(np.isfinite(res.poses[res.ok]).all()), "non-finite pose where ok")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[5] bf16 bench config, {n_frames} frames of 512^2, frame_batch 16, 7000 points: "
        f"{n_frames / wall:.2f} poses/s ({wall:.3f} s wall, synchronised), peak memory "
        f"{peak:.2f} GiB, ok {int(res.ok.sum())}/{n_frames}, median matches "
        f"{int(np.median(res.num_matches))} on {smi}")
    return counts, model, frames, anno


K1_NAMES = ("kv_partial_kernel", "kv_reduce_kernel", "apply_kernel")
K2_NAMES = ("lse_kernel", "col_lse_reduce", "argmax_kernel", "col_argmax_reduce")
K3_NAMES = ("window_gather_kernel",)


def phase6(model, frames, anno, smi: str) -> None:
    """Where the time goes in one bf16 step of phase 5 (the first 16 frames)."""
    dev = "cuda"
    chunk = frames[:B]
    batch = {
        "query_image": torch.from_numpy(np.stack([f["image"][..., None] for f in chunk])).to(dev),
        "intrinsics": torch.from_numpy(np.stack([f["K"] for f in chunk])).to(dev),
        **{k: torch.from_numpy(v).to(dev) for k, v in anno.items()},
    }
    gt = torch.from_numpy(np.stack([f["pose_gt"] for f in chunk])).to(dev)
    step = make_query_step(model)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    walls = []
    for i in range(8):  # 3 warm-ups, then 5 timed steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch, gen, gt)
        torch.cuda.synchronize()
        if i >= 3:
            walls.append(1e3 * (time.perf_counter() - t0))
    wall = float(np.median(walls))
    # the model forward alone, on the inputs the step hands it
    fwd_batch = {**batch, "query_image": batch["query_image"].float() / 255.0,
                 **{k: batch[k][None].expand(B, *batch[k].shape) for k in anno}}
    fwd = time_ms(lambda: model(fwd_batch), reps=5, warmup=1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        step(batch, gen, gt)
        torch.cuda.synchronize()
    rows = sorted(((e.device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                   if e.device_type.name == "CUDA" and e.device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    check(busy > 0, "the profiler saw no device time in the step")

    def group(names):
        pat = re.compile(r"\b(" + "|".join(names) + r")\b")
        return sum(r[0] for r in rows if pat.search(r[2]))

    k1, k2, k3 = group(K1_NAMES), group(K2_NAMES), group(K3_NAMES)
    log(f"[6] bf16 step, {B} frames of 512^2, 7000 points, 512 slots: wall {wall:.2f} ms "
        f"(median of 5, synchronised), model forward {fwd:.2f} ms (CUDA events, median of 5), "
        f"device time in one profiled step {busy:.2f} ms, idle share "
        f"{100 * (1 - busy / wall):.1f} % of the step wall, on {smi}")
    log(f"[6] device time: K1 {k1:.2f} ms, K2 {k2:.2f} ms, K3 {k3:.3f} ms, "
        f"everything else {busy - k1 - k2 - k3:.2f} ms")
    for ms, count, key in rows[:25]:
        log(f"[6]   {ms:9.3f} ms  x{count:<5d} {key[:100]}")


def main() -> int:
    smi = phase0()
    phase1()
    no_tf32()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    records = {"K1_encoder_layer": phase2_k1(gen), "K2_rowcol_stats": phase2_k2(gen),
               "K3_window_gather": phase2_k3(gen)}
    torch.cuda.empty_cache()
    phase3()
    phase4()
    counts, model, frames, anno = phase5(smi)
    phase6(model, frames, anno, smi)
    check("jax" not in sys.modules, "the port loaded JAX")
    kernel_lines = [
        {"name": name, "route": "cuda", **meta, "launches": counts[name], **records[name]}
        for name, meta in KERNELS.items()
    ]
    log(smi)
    print(json.dumps({"kernels": kernel_lines}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
