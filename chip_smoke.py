#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``onepose_plus_plus_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py         # needs one CUDA GPU
    python3 chip_smoke.py 8m      # phases 0 and 1, then the named phases alone (those of STANDALONE)

Phases, all run every time unless phases are named (each prints its own
lines; any failure raises and exits non-zero), in this order but for 8a and
9a, which run right after phase 2, and phase 10, which runs right after
phase 6; phase 11 runs last:
  0  device: GPU name and power limit, torch and CUDA versions
  1  build the CUDA kernels from csrc/ (nvcc, -Xptxas -v report)
  2  each kernel against its plain PyTorch version at main-path shapes
     (batch 16), f32 and bf16, with CUDA-event medians over 20 runs; K1 also
     at the LoFTR shape [8, 4096, 256], with masks and at a small ragged shape,
     timed with packed weights and split by launch, a bf16 and an f32 layer
     at C = 64 through K1's tensor-core chains (C padded to 64 channels), and
     K1 at the JAX kernel's widths above 512, a one-head layer, its own tests'
     other widths ((640, 8), (768, 8), (1024, 8), (2048, 16), (512, 1),
     (256, 4), (128, 8)) and head widths 24 and 8 ((384, 16), (128, 16)), in
     both dtypes (f32: the split-TF32 chain, max|d| <= 1e-4; bf16: the bf16
     chain), bitwise repeatable, by kernel name, faster as whole calls than
     the plain version, each with its device time, plain version and bound;
     the chains at self [4, 4096, C] for C = 512, 1024 and 2048, bf16 at
     (512, 64) (head width 8) and both dtypes at C = 64, 96 and 160 (8 heads),
     bitwise repeatable, with their share of the operations bound (f32: of
     the f32 bound and of the 3xTF32 floor; at C = 512 the mean distance to
     the layer in float64, within 2x plain f32's, beside single TF32's); at
     (256, 8), self [16, 7000, 256], the bf16 chain through a forced pack
     beside "tc" in turns, and the routed split-TF32 chain against plain f32,
     bitwise repeatable, within 2x plain f32's distance to float64;
     K3 exact at the query shape (both
     dtypes) and the train shape (f32), ids at the grid's corners and out of
     range, whole call and device time beside index_select; K2's bf16 (tensor-core)
     instance split by launch, its two launches bitwise equal, faster than its
     plain version; K2 above 576 channels on the channel-streaming tensor-core
     tile, bf16 ("wide_bf16") and f32 in split TF32 ("wide_tf32"), at
     [2,1000]x[2,700] with a column mask at C = 640 and 1000 and at
     [16,7000]x[16,4096] at C = 640, 1024 and 2048, against the plain version
     (1e-3, argmaxes 99.9 %), bitwise repeatable, by kernel name, with device
     time by launch, plain version and bound; its mean row-LSE distance to
     float64 at C = 2048 (wide_tf32 within 2x plain f32's) and the fused
     selection's match set on planted features at C = 1024 in bf16 (Jaccard
     >= 0.98); the f32 instances of K1 and K2 (split TF32 on the tensor
     cores) at [16, ...], at batch 1 (a tracking frame's shapes) and K2 at the
     train shape [4, ...], each with its f32 bound and 3xTF32 floor, split by
     launch name. Every phase that runs K1 or K2 in f32 at C = 256 (3, 7c, 7d,
     8b, 8d, 9e) checks by the profiler's kernel names that the split-TF32
     instances ran (K1's chain) and no bf16 kernel of K1; 2n K3, K4 and K6
     at pixels no 16-byte vector divides (bf16 C = 196, 130, 33; f32 C = 130,
     33: K3's span copy window_span_kernel, K4's span sum window_sum_kernel,
     K6's span copy) at the query, train and sparse-FPN shapes, K3 and K6
     bitwise equal to their plain versions (K6 also on maps 2, 4 and 8 bytes
     past an alignment), K4 within 7a's tolerances and bitwise repeatable,
     each kernel by name, with its whole call, device time (K4's index launch
     and sum apart) and host time a call, beside its bound and index_select
     or zero_ + index_add_
  3  the query-pose forward in f32 on the GPU (kernels) against the same
     forward on the CPU (plain versions): full-width default config, 2 frames
     of 512^2, a 7000-point cloud, 512 match slots, thr 0, with K1's f32
     launches and device time in that forward; then K2's bf16
     instance on that forward's coarse features against the plain bf16 version:
     the same match set
  4  batched RANSAC-PnP on the GPU: 16 frames, 512 noisy correspondences each
     against GT; then the query step's PnP through PnPGraphs at 16 and 48
     frames (512 slots, 512 hypotheses): the replays bitwise the eager
     solver's, and one eager call against one replay (wall ms, device ms
     between two events, kernels launched)
  5  run_inference at the bench configuration (bf16, 512 slots, 48 frames of
     512^2, frame_batch 16, 7000 points, GT poses): launch counts of every
     kernel, finite poses, poses/s and peak memory
  5m phase 5's run through run_inference(mesh=): make_mesh("cuda", 0, 1), NCCL
     at world 1 (one rank a GPU; world 1 needs one), the result bitwise equal to
     phase 5's, launch counts, poses/s, peak memory and the wall of the one
     gather; release_mesh() before any later phase makes its process group
  6  where the time goes in one bf16 step of phase 5 (16 frames): step wall,
     model forward, device time per kernel (torch.profiler), idle share, and
     the eager fine transformer's device time at the step's fine shapes and
     its share of the step
  7  training: 7a K4 and 7b K5 against their plain versions at the train
     shapes (map [4,256,256,128] with 1228 slots; [4,7000]x[4,4096]x256), K5's
     feature gradients bf16 values times the scale from both instances (the
     resident tile at C = 256, the wide one at 1024, feat_norm on and off), K4's
     index launch exactly equal to the plain index preparation and its two
     launches timed apart (as in 2n: host time a call, zero_ + index_add_, the
     bound with K4's own index arrays), K5's launches split by kernel, bitwise
     repeatable and faster than its plain version;
     7f K5 at the coarse widths above 256 at the train shapes: C = 384 and 512
     (the resident tile, feature gradients in 256-channel chunks), 640, 1024,
     2048 and 4096 (the wide instance: K2's channel-streaming tile, feature
     gradients in thread-block clusters of 3-16 blocks), forward and backward
     within 7b's tolerances, bitwise repeatable, split by launch, with the
     cluster size;
     7c one f32 micro-batch on the GPU (kernels) against the same micro-batch
     on the CPU (plain versions), loss and every gradient, at the train
     config's coarse width (256), at 512 (K5 once forward, once backward,
     in two chunks) and at 1024 (K2's wide_tf32, K5's wide instance: its
     launches checked by name);
     7d the train config
     at full width (f32, 4 frames of 512^2, 7000 points, grad_accum 2), three
     optimizer updates on one batch: falling loss, launch counts, step time,
     peak memory and a torch.profiler split of one micro-batch
  8  the keypoint-free SfM: 8a K6 against its plain version at the refine
     (K 1024) and extract (K 4096) shapes, W 9, on a [8,256,256,128] map,
     through gather_windows with int32 centres as the refine calls it (one
     launch), also on maps 2, 4 and 8 bytes past an alignment: whole call,
     device and host time, index_select and the bound;
     8b the LoFTR pair matcher in f32 on the GPU against the CPU, full width,
     one 512^2 pair, all three modes; 8c the SfM configuration
     (configs/preprocess/sfm_inference_onepose.yaml, bf16, pair batch 8, 1024
     slots, LM) at full width on a 20-frame plane-rendered object of 512^2:
     every stage of run_sfm in its order, on in-memory images with the match
     gallery, PLY and h5 exports off (the staged timing; phase 11 runs the
     SfM CLI with them), launch counts, stage walls, pairs/s, peak memory and each
     stage's peak, then descriptor extraction at its shape through the
     self-pair refine it ran before (fine stage included) and through
     extract, wall and peak memory of each, outputs bitwise equal; 8m LoFTR's
     outdoor matcher on padded MegaDepth-1500 views (1200 x 800 and 800 x 1200
     padded to 1200^2: 22 500 coarse cells, 15 000 valid): K1's bf16 tc
     instance with padding masks at [4, 22500, 256], self and cross, and K2
     with row_add and col_add at [4, 22500] x [4, 22500], against their plain
     versions, each timed; one batch of run_pairs through make_loftr_match_fn
     (bf16, 5120 slots), its K1, K2 and K3 launches counted from 0 against
     one call's, every match inside its view's valid extent; 8d the same
     stages in f32 on a 6-frame object of 256^2, GPU against CPU
  9  the serving entry points and K7: 9a K7 against its plain version at the
     fine transformer's four (L, S) shapes, M 8192 (and 8189, not a multiple
     of 8), f32 (CUDA cores) and bf16 (tensor cores, by kernel name), two
     launches bitwise equal; 9b the fine transformer (bf16, random weights) through
     K7 (ops.cuda_short_encoder.fine_transformer_short, the workload K7 was
     written for; no path of the model routes to it) against the port's eager
     fine transformer at [8192, 25, 128] and [24576, 25, 128]; 9c the bench
     script's main() at its defaults (its JSON line, then peak memory and launch
     counts); 9d the inference CLI at full width (bf16) on a 32-frame video of
     a textured plane at 512^2, whose 7000-point annotation carries the
     random-weight model's own features, so that poses are held to GT; 9e the
     tracking demo at full width (its configuration: f32) on 30 such frames,
     every third one blank (tracking lost), with 15 DB views: launch counts
     the detect/track sequence implies, per-frame latency of each mode, poses
     against GT. 9c-9e run with PyTorch's default TF32 settings, as a fresh
     CLI process does
 10  the options that are off by default: 10a K6 at the sparse fine FPN's
     pin map (bf16, 196 channels: [16, 256, 256, 196], K 512, W 9, int64
     corners, invalid slots) and at C = 130 bitwise against the plain version
     (also on maps past an alignment), timed as in 8a; 10b the sparse query
     step at the bench shapes (16 frames of 512^2, bf16) against the dense
     step on the same weights: the same match set, windows within one bf16
     step, one K6 and no K3 launch (its own run, counts from 0), both steps'
     wall and device time in turns; the f32 forwards with mkpts_query_f within
     1e-2 px; 10c the int8 backbone: each quantized conv's
     int32 sums bitwise against the CPU, the 16-frame bf16 step with
     quant_int8 against the float step (JAX's bounds on the backbone's maps,
     the match sets' Jaccard) and the backbone's time int8 against bf16; 10d
     ResNetFPN_16_4 (default widths), ResNet18_C at stages 2 and 3 (both block
     types) and the LayerNorm keypoint encoder, the card against the CPU
 11  the user's CLI chains through each CLI's main(argv) with the shipped
     configs at full width, no device= argument (each CLI's default, cuda),
     random weights: 11a the demo pipeline of scripts/torch_demo_pipeline.sh
     (a synthetic ARKit capture of 50 + 20 frames -> parse_scanned_data ->
     sfm +preprocess=sfm_demo -> demo), 11b the evaluation chain on 8c's
     object (sfm +preprocess=sfm_inference_onepose with its match gallery and
     h5 exports -> inference +experiment=inference_onepose -> merge); every
     file each stage writes, both h5 files read back with the port's reader
     against raw_matches.pkl, each stage's launches against the counts its
     matcher calls, frames and steps imply, its wall and peak memory

Every kernel's record carries its time, its plain version's, the time of one
PyTorch call that computes the same function where there is one, and its
bound: the larger of the bytes it must move over 3.35 TB/s and its operations
over the peak rate of their type (989 TFLOP/s bf16, 67 TFLOP/s f32), from
this run's inputs. The second-to-last line is the kernels' JSON record, the
last line ``{"ok": true, "device": {...}}``. Weights are random, drawn from a
numpy seed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from onepose_plus_plus_tpu_torch import bench, demo, kernels
from onepose_plus_plus_tpu_torch.config import (
    CoarseMatchingConfig,
    KeypointEncodingConfig,
    LoFTRConfig,
    OnePosePlusConfig,
    ResNetFPNConfig,
    TransformerConfig,
)
from onepose_plus_plus_tpu_torch.eval.metrics import batched_pose_errors
from onepose_plus_plus_tpu_torch.eval.trajectory import absolute_trajectory_error, camera_centers_from_poses
from onepose_plus_plus_tpu_torch.geometry.levenberg_marquardt import lm_solve_scalar
from onepose_plus_plus_tpu_torch.geometry.residuals import depth_residual_and_derivative, depth_residual_track
from onepose_plus_plus_tpu_torch.geometry.rotations import matrix_to_angle_axis
from onepose_plus_plus_tpu_torch.geometry.pnp import PnPGraphs, ransac_pnp, ransac_pnp_from_samples, sample_hypotheses
from onepose_plus_plus_tpu_torch.inference import cli as inference_cli
from onepose_plus_plus_tpu_torch.inference import pipeline
from onepose_plus_plus_tpu_torch.inference.pipeline import make_query_step, run_inference
from onepose_plus_plus_tpu_torch.models.backbone import build_backbone
from onepose_plus_plus_tpu_torch.models.build import (
    build_loftr_matcher,
    build_onepose_model,
    loftr_matcher_from_dict,
    make_loftr_fns,
    make_loftr_match_fn,
)
from onepose_plus_plus_tpu_torch.models.loftr import LoFTRMatcher
from onepose_plus_plus_tpu_torch.models.transformer import LoFTREncoderLayer
from onepose_plus_plus_tpu_torch.models.onepose_plus import OnePosePlusModel, normalize_3d_keypoints
from onepose_plus_plus_tpu_torch.models.position_encoding import KeypointEncoder, sine_position_encoding
from onepose_plus_plus_tpu_torch.parallel.mesh import make_mesh, release_mesh
from onepose_plus_plus_tpu_torch.ops.cuda_coarse_loss import (
    coarse_focal_sums,
    coarse_focal_sums_plain,
    fused_coarse_focal_loss,
    k5_instance,
)
from onepose_plus_plus_tpu_torch.ops.cuda_encoder import (
    PackedEncoderWeights,
    chunk_images,
    encoder_layer_plain,
    fused_encoder_layer,
    fused_encoder_layer_packed,
    k1_instance,
    pack_encoder_weights,
)
from onepose_plus_plus_tpu_torch.ops.cuda_gather import (
    _window_taps,
    scatter_index,
    scatter_index_plain,
    window_gather,
    window_gather_plain,
    window_instance,
    window_scatter,
    window_scatter_plain,
)
from onepose_plus_plus_tpu_torch.ops.cuda_matching import (
    dual_softmax_rowcol_stats,
    fused_select_topk_matches,
    k2_instance,
    rowcol_stats_plain,
)
from onepose_plus_plus_tpu_torch.ops import quant
from onepose_plus_plus_tpu_torch.ops.cuda_patch_gather import patch_gather, patch_gather_plain, patch_taps
from onepose_plus_plus_tpu_torch.ops.window_gather import gather_windows
from onepose_plus_plus_tpu_torch.ops.cuda_short_encoder import (
    fine_transformer_short,
    fused_short_encoder_layer,
    fused_short_encoder_layer_packed,
    pack_short_encoder_weights,
    short_encoder_layer_plain,
)
from onepose_plus_plus_tpu_torch.ops.matching import sample_gt_rows
from onepose_plus_plus_tpu_torch.ops.window_gather import gather_windows_aligned
from onepose_plus_plus_tpu_torch.data import colmap_model
from onepose_plus_plus_tpu_torch.data.colmap_model import model_stats
from onepose_plus_plus_tpu_torch.data.preprocessing import save_3d_annotation
from onepose_plus_plus_tpu_torch.sfm.annotation import build_annotations
from onepose_plus_plus_tpu_torch.sfm.cli import CONFIGS_DIR, sfm_config
from onepose_plus_plus_tpu_torch.sfm.coarse_match import PairMatches, merge_keypoints, run_pairs
from onepose_plus_plus_tpu_torch.sfm.incremental import incremental_sfm
from onepose_plus_plus_tpu_torch.sfm.filtering import (
    filter_by_3d_box,
    filter_track_length,
    merge_close_points,
    track_length_for_budget,
)
from onepose_plus_plus_tpu_torch.sfm.pairs import pose_covisibility_pairs
from onepose_plus_plus_tpu_torch.sfm.post_optimization import (
    assign_keyframes_greedy,
    build_depth_problems,
    build_refinement_pairs,
    optimize_depths,
    run_fine_refinement,
    write_back,
)
from onepose_plus_plus_tpu_torch.sfm.runner import extract_keypoint_descriptors
from onepose_plus_plus_tpu_torch.sfm.triangulate import triangulate_scene
from onepose_plus_plus_tpu_torch.train import callbacks as train_callbacks
from onepose_plus_plus_tpu_torch.train import cli as train_cli
from onepose_plus_plus_tpu_torch.train.losses import LossConfig, compute_losses
from onepose_plus_plus_tpu_torch.utils.config_loader import load_config
from onepose_plus_plus_tpu_torch.train.train_step import TrainConfig, make_optimizer, train_step
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
        # the record's numbers are the bf16 instance's at C = 256; phase 2 prints the others'
        "instances": {"tc": "onepose_plus_plus_tpu_torch/csrc/sim_tile_tc.cuh",
                      "tf32x3": "onepose_plus_plus_tpu_torch/csrc/sim_tile_tf32.cuh",
                      "wide_bf16, wide_tf32": "onepose_plus_plus_tpu_torch/csrc/sim_tile_wide.cuh"},
    },
    "K3_window_gather": {
        "source": "onepose_plus_plus_tpu_torch/csrc/gather.cu",
        "replaces": "onepose_plus_plus_tpu/ops/pallas_gather.py:169",
    },
    "K4_window_scatter": {
        "source": "onepose_plus_plus_tpu_torch/csrc/scatter.cu",
        "replaces": "onepose_plus_plus_tpu/ops/pallas_gather.py:79",
    },
    "K5_coarse_loss": {
        "source": "onepose_plus_plus_tpu_torch/csrc/coarse_loss.cu",
        "replaces": "onepose_plus_plus_tpu/ops/pallas_coarse_loss.py:459",
        # the record's numbers are the resident tile's at C = 256; phase 7f prints the wide instance's
        "instances": {"tc": "onepose_plus_plus_tpu_torch/csrc/sim_tile_tc.cuh",
                      "wide": "onepose_plus_plus_tpu_torch/csrc/sim_tile_wide.cuh"},
    },
    "K6_patch_gather": {
        "source": "onepose_plus_plus_tpu_torch/csrc/patch_gather.cu",
        "replaces": "onepose_plus_plus_tpu/ops/pallas_patch_gather.py:70",
    },
    "K7_short_encoder": {
        "source": "onepose_plus_plus_tpu_torch/csrc/short_encoder.cu",
        "replaces": "experiments/pallas_short_encoder.py:146",
    },
}
TRAIN_B, TRAIN_P, TRAIN_IMG = 4, 7000, 512  # the train config: frames per micro-batch, points, size


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def turns_ms(fa, fb, reps: int = 10):
    """Whole-call ms of fa and fb timed in turns (a, b, b, a, a, b, b, a), each
    the least of its four turns' medians: calls of a few launches are bound by
    the host, whose stalls within a run only ever slow a turn."""
    a, b = [], []
    for side in (a, b, b, a, a, b, b, a):
        side.append(time_ms(fa if side is a else fb, reps))
    return min(a), min(b)


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


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor cores; f32 CUDA cores


def bound(n_bytes: float, ops: float, dtype: torch.dtype) -> dict:
    """Least time of the work on the card: bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / PEAK_OPS_PER_S[dtype]
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def gather_bytes(flat: torch.Tensor, valid: torch.Tensor, hw_pixels: int, row_bytes: int,
                 out: torch.Tensor, index_bytes: int) -> float:
    """Bytes a window/patch gather must move: the output written once, each map
    pixel its taps cover read once (this run's indices), the indices read once."""
    n = flat.shape[0]
    pix = (flat + hw_pixels * torch.arange(n, device=flat.device)[:, None])[valid]
    return out.numel() * out.element_size() + torch.unique(pix).numel() * row_bytes + index_bytes


def index_select_table(feat: torch.Tensor, flat: torch.Tensor, valid: torch.Tensor):
    """(table, idx) for the one-call library yardstick of a gather: the flat map
    with one zero row appended, and precomputed row indices (out-of-map taps
    point at the zero row); ``torch.index_select(table, 0, idx)`` then computes
    the gather's output."""
    n, h, w, c = feat.shape
    table = torch.cat([feat.reshape(n * h * w, c), feat.new_zeros(1, c)])
    rows = flat + h * w * torch.arange(n, device=flat.device)[:, None]
    return table, torch.where(valid, rows, torch.full_like(rows, n * h * w)).reshape(-1)


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


def phase1(smi: str) -> None:
    lib = kernels.build(verbose=True)
    log(f"[1] built {lib.path.name} in {lib.build_seconds:.2f} s")
    entry = ""
    for line in lib.compiler_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m or line.startswith("--- "):  # a kernel, or the next source's log
            entry = m.group(1) if m else line[4:]  # a kernel's mangled name, or the source's
        if "registers" in line or "spill" in line or "error" in line.lower():
            log(f"[1]   {entry}: {line.strip()}")
    phase1_depth_derivative(smi)


def _depth_problems(rng, n: int, v: int, device: str):
    """n SfM depth problems (a keyframe observation and v related views each)
    of a synthetic ring scene, 0.3 px noise, depths 15 % off: the arguments of
    ``depth_residual_track`` and the initial depths, on ``device``."""
    K, pts, Ts = _scene(rng, v + 1, n)
    aa = matrix_to_angle_axis(torch.from_numpy(Ts[:, :3, :3])).numpy()
    proj = [(pts @ T[:3, :3].T + T[:3, 3]) for T in Ts]
    uv = [p[:, :2] / p[:, 2:3] @ K[:2, :2].T + K[:2, 2] for p in proj]
    uv1 = np.stack(uv[1:], axis=1) + rng.normal(0, 0.3, (n, v, 2))
    valid = np.ones((n, v), bool)
    valid[::4, -1] = False
    args = (uv[0], uv1, np.broadcast_to(K, (n, 3, 3)), np.broadcast_to(K, (n, v, 3, 3)),
            np.broadcast_to(aa[0], (n, 3)), np.broadcast_to(Ts[0][:3, 3], (n, 3)),
            np.broadcast_to(aa[1:], (n, v, 3)), np.broadcast_to(Ts[1:, :3, 3], (n, v, 3)), valid)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, bool if a.dtype == bool else np.float32)).to(device)  # noqa: E731
    d0 = proj[0][:, 2] * rng.uniform(0.85, 1.15, n)
    return tuple(map(t, args)), t(d0), proj[0][:, 2]


def phase1_depth_derivative(smi: str) -> None:
    """The SfM depth solver's first call in the process: with the residual's
    closed-form derivative (the solver's route now), then through forward
    mode (its route before: the first torch.func.jvp of a process pays a
    set-up of seconds); the two derivatives and solutions agree."""
    n_tracks, n_views = 20000, 4
    args, d0, depth = _depth_problems(np.random.default_rng(11), n_tracks, n_views, "cuda")
    torch.ones(1, device="cuda").sum().item()  # the CUDA context exists before either clock starts

    def forward_mode(d, *a):  # the same residual without its closed form
        return depth_residual_track(d, *a)

    walls = {}
    for tag, fn in (("closed form", depth_residual_track), ("forward mode (torch.func.jvp)", forward_mode)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        walls[tag] = lm_solve_scalar(fn, d0, args)[0]
        torch.cuda.synchronize()
        log(f"[1] depth solver's first call, derivative by {tag}: {time.perf_counter() - t0:.3f} s "
            f"({n_tracks} tracks, {n_views} views, 20 LM iterations) on {smi}")
    (r, dr), (r_f, dr_f) = depth_residual_and_derivative(d0, *args), torch.func.jvp(
        lambda d: depth_residual_track(d, *args), (d0,), (torch.ones_like(d0),))
    rel = float((dr - dr_f).abs().max() / dr_f.abs().max())
    d_closed, d_fwd = walls.values()
    sol = float(((d_closed - d_fwd).abs() / d_fwd.abs()).max())
    err = float(np.abs(d_closed.cpu().numpy() - depth).max())
    log(f"[1] closed-form derivative against forward mode: max |d| {rel:.2e} of the largest entry "
        f"(tolerance 1e-5, float32), residuals equal {bool(torch.equal(r, r_f))}; solved depths agree to "
        f"{sol:.2e} relative (tolerance 1e-4), within {err:.4f} of the truth")
    check(rel <= 1e-5 and torch.equal(r, r_f) and sol <= 1e-4 and err < 0.05,
          "the closed-form depth derivative disagrees with forward mode")


# ----------------------------------------------------------------- phase 2


def _layer_weights(gen, c):
    """Random weights of one encoder layer ([in, out] layout), as K1 and K7 take them."""
    rn = lambda *shape, scale=1.0: torch.randn(*shape, generator=gen, device="cuda") * scale  # noqa: E731
    return dict(
        wq=rn(c, c, scale=c ** -0.5), wk=rn(c, c, scale=c ** -0.5), wv=rn(c, c, scale=c ** -0.5),
        wmerge=rn(c, c, scale=c ** -0.5), ln1_scale=1 + rn(c, scale=0.1), ln1_bias=rn(c, scale=0.1),
        wmlp0=rn(2 * c, 2 * c, scale=(2 * c) ** -0.5), wmlp1=rn(2 * c, c, scale=(2 * c) ** -0.5),
        ln2_scale=1 + rn(c, scale=0.1), ln2_bias=rn(c, scale=0.1),
    )


def _encoder_inputs(gen, l, s, c=256, n=B):
    x = torch.randn(n, l, c, generator=gen, device="cuda")
    src = x if s is None else torch.randn(n, s, c, generator=gen, device="cuda")
    return x, src, _layer_weights(gen, c)


def _bf16(t):
    return t.to(torch.bfloat16)


K1_PREVIOUS_MS = 7.455  # the CUDA-core design at the recorded shape (NVIDIA H100 80GB HBM3, 700.00 W)


def phase2_k1(gen) -> dict:
    """K1 against its plain version: the query step's two shapes, the LoFTR
    shape, a masked and a small ragged case; f32 (split TF32) and bf16 operands
    (tensor cores). Timed with packed weights, as the model calls it."""
    worst, rec = 0.0, {}
    cases = (("cross", B, 4096, 7000, False), ("self", B, 7000, None, False),
             ("loftr-self", 8, 4096, None, False), ("masked-cross", 4, 4096, 7000, True),
             ("ragged", 3, 130, 257, True))
    for tag, n, l, s, masked in cases:
        x, src, w = _encoder_inputs(gen, l, s, n=n)
        masks = {}
        if masked:
            masks = {"x_mask": torch.rand(n, l, generator=gen, device="cuda") < 0.8,
                     "source_mask": torch.rand(n, src.shape[1], generator=gen, device="cuda") < 0.8}
        got = fused_encoder_layer(x, src, **w, **masks, nhead=8)
        ref = encoder_layer_plain(x, src, **w, **masks, nhead=8)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        log(f"[2] K1 {tag} f32  x{tuple(x.shape)} src{tuple(src.shape)}{' masked' if masked else ''}: "
            f"max|d| {err:.3e} (<= 1e-3)")
        check(err <= 1e-3 and bool(torch.isfinite(got).all()), f"K1 {tag} f32 disagrees: {err}")
        worst = max(worst, err)
        # bf16 product operands; x and source stay f32, as on the main path.
        # The tensor cores sum each product in another order than the plain
        # version, so a rounded operand can land on the neighbouring bf16 value
        wb = {k: (_bf16(v) if v.dim() == 2 else v) for k, v in w.items()}
        got = fused_encoder_layer(x, src, **wb, **masks, nhead=8, dtype=torch.bfloat16)
        ref = encoder_layer_plain(x, src, **wb, **masks, nhead=8, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        d = (got - ref).abs()
        log(f"[2] K1 {tag} bf16 operands: max|d| {d.max().item():.3e} (<= 5e-2), "
            f"mean|d| {d.mean().item():.3e} (<= 5e-3)")
        check(d.max().item() <= 5e-2 and d.mean().item() <= 5e-3 and bool(torch.isfinite(got).all()),
              f"K1 {tag} bf16 disagrees")
        if masked:
            continue
        for dt, dtype, ws in (("f32", torch.float32, w), ("bf16", torch.bfloat16, wb)):
            packed = pack_encoder_weights(**ws, nhead=8, dtype=dtype)
            ms = time_ms(lambda: fused_encoder_layer_packed(x, src, packed))
            loose = time_ms(lambda: fused_encoder_layer(x, src, **ws, nhead=8, dtype=dtype))
            pms = time_ms(lambda: encoder_layer_plain(x, src, **ws, nhead=8, dtype=dtype))
            log(f"[2] K1 {tag} {dt}: kernel {ms:.3f} ms with packed weights ({loose:.3f} ms packing "
                f"loose weights at the call), plain {pms:.3f} ms (median of 20)")
            rec[f"{tag}_{dt}"] = (ms, pms)
            if dt == "bf16":
                rows, busy, _ = device_rows(lambda: fused_encoder_layer_packed(x, src, packed), reps=5)
                log(f"[2] K1 {tag} bf16 device time by launch: {launch_names(rows)} "
                    f"({busy / 5:.3f} ms a call, torch.profiler, 5 calls)")
    ms, pms = rec["self_bf16"]
    # the recorded instance: self [B, 7000, 256], bf16 product operands, f32 streams
    l, c, hd = 7000, 256, 256 // 8
    ops = B * (16 * l * c * c + 4 * l * c * c + 4 * l * c * (hd + 1))  # 6 projections + FFN, K'^T[V|1], apply
    n_bytes = 2 * B * l * c * 4 + 10 * c * c * 2 + 4 * c * 4  # x in, out, bf16 weights, LayerNorms
    b = bound(n_bytes, ops, torch.bfloat16)
    log(f"[2] K1 self bf16 {ms:.3f} ms ({K1_PREVIOUS_MS} ms before the tensor-core design), "
        f"{ms / b['bound_ms']:.1f}x its bound {b['bound_ms']:.4f} ms ({b['bound_by']}); no single "
        f"PyTorch call computes a linear-attention encoder layer")
    check(ms < K1_PREVIOUS_MS, "K1's tensor-core instance is not faster than the CUDA-core design")
    fb = bound(n_bytes + 10 * c * c * 2, ops, torch.float32)  # f32 weights
    log(f"[2] K1 self f32 (the demo's instance): bound {fb['bound_ms']:.4f} ms ({fb['bound_by']}) "
        f"at 67 TFLOP/s; kernel {rec['self_f32'][0]:.3f} ms")
    phase2_k1_narrow(gen)
    phase2_k1_wide(gen)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": pms, **b, "library_ms": None}


def phase2_k1_narrow(gen) -> None:
    """A layer at a width no JAX kernel takes (C = 64, 8 heads, as the narrow
    configurations), through the model's layer: bf16 operands on the bf16
    chain, f32 on the split-TF32 chain (C padded to 64 channels, 16 rows of
    head sums at head width 8), each held to the plain version, bitwise
    repeatable, by kernel name, with its whole call, device time and bound."""
    x = torch.randn(4, 1000, 64, generator=gen, device="cuda")
    src = torch.randn(4, 700, 64, generator=gen, device="cuda")
    for dt, dtype, instance, names in (("bf16", torch.bfloat16, "tcw", K1_TCW_NAMES),
                                       ("f32", torch.float32, "tcw_tf32", K1_TCW32_NAMES)):
        torch.manual_seed(0)
        layer = LoFTREncoderLayer(64, 8, "linear", dtype=dtype).cuda().eval()
        with torch.no_grad():
            before = kernels.launch_counts()["K1_encoder_layer"]
            got = layer(x, src, fused=True)
            launched = kernels.launch_counts()["K1_encoder_layer"] - before
            again = layer(x, src, fused=True)
            ref = encoder_layer_plain(x, src, *layer.kernel_weights(), nhead=8, dtype=dtype)
            rows, busy, _ = device_rows(lambda: layer(x, src, fused=True), reps=5)
            ms = time_ms(lambda: layer(x, src, fused=True))
            pms = time_ms(lambda: encoder_layer_plain(x, src, *layer.kernel_weights(), nhead=8, dtype=dtype))
        torch.cuda.synchronize()
        d = (got - ref).abs()
        ok = d.max().item() <= TCW32_MAX_ERR if dt == "f32" else d.max().item() <= 5e-2 and d.mean().item() <= 5e-3
        b = bound(*k1_work(4, 1000, 700, c=64, w_bytes=dtype.itemsize), dtype)
        tol = f"(<= {TCW32_MAX_ERR:g})" if dt == "f32" else "(<= 5e-2)"
        log(f"[2] K1 {dt} at C = 64, 8 heads, x{tuple(x.shape)} src{tuple(src.shape)}: instance "
            f"{layer.packed_weights().instance!r}, {launched} launch, max|d| {d.max().item():.3e} {tol}, "
            f"mean|d| {d.mean().item():.3e}{'' if dt == 'f32' else ' (<= 5e-3)'}")
        log(f"[2] K1 {dt} at C = 64: two launches bitwise equal {torch.equal(got, again)}; kernel {ms:.4f} ms whole "
            f"call, device {busy / 5:.4f} ms a call, plain {pms:.4f} ms (medians of 20); bound {b['bound_ms']:.5f} ms "
            f"({b['bound_by']}, {'989 TFLOP/s bf16' if dt == 'bf16' else '67 TFLOP/s f32'}), "
            f"{100 * b['bound_ms'] / (busy / 5):.1f} % of it by device time; launches {launch_names(rows)}; no single "
            f"PyTorch call computes the layer")
        check(layer.packed_weights().instance == instance and launched == 1 and ok
              and bool(torch.isfinite(got).all()) and torch.equal(got, again),
              f"K1's {instance} chain disagrees at C = 64")
        check(only_launches(rows, names), f"a C = 64 {dt} layer launches {launch_names(rows)}")


K1_WIDE = ((640, 8), (768, 8), (1024, 8), (2048, 16), (512, 1))  # (C, heads) the JAX kernel takes above 512 / wide heads
K1_JAX_TEST_WIDTHS = ((256, 4), (128, 8))  # the JAX kernel's own tests' widths besides (256, 8)
K1_NARROW_HEADS = ((384, 16), (128, 16))  # head widths 24 and 8: 16 heads a 128-column attention block
K1_TCW_REALISTIC = ((512, 8), (1024, 8), (2048, 16))  # the chains at self [4, 4096, C]
K1_HEAD8_REALISTIC = ((512, 64),)  # bf16 at head width 8 (16 sum rows) at self [4, 4096, C]
# both dtypes below 128 and at C not a multiple of 64 (head widths 8, 12 and 20) at self [4, 4096, C]
K1_NARROW_REALISTIC = ((64, 8), (96, 8), (160, 8))
_W_KEYS = ("wq", "wk", "wv", "wmerge", "wmlp0", "wmlp1")


def _forced_pack(packed: PackedEncoderWeights, ws: dict, instance: str) -> PackedEncoderWeights:
    """The same layer packed for another tensor-core instance of its operand
    type than the one the router picks, to time the two side by side."""
    loose = tuple(ws[k].to(packed.dtype).contiguous() for k in _W_KEYS)
    return PackedEncoderWeights(packed.dtype, packed.nhead, packed.width, (), packed.ln,
                                *chunk_images(instance, *loose), instance)


TCW32_MAX_ERR = 1e-4  # "tcw_tf32" against plain f32: split TF32 passes it, one TF32 product does not


def phase2_k1_wide(gen) -> None:
    """K1 at the JAX kernel's widths above 512, at a head as wide as the layer,
    at its own tests' other widths (256, 4), (128, 8) and at head widths 24 and
    8 (16 heads a 128-column attention block): f32 operands on the split-TF32
    chain, bf16 operands on the bf16 chain, held to the plain version, bitwise
    repeatable, by kernel name, and timed as whole calls beside the plain
    version (the CUDA-core kernels that ran some of these widths before are
    timed against the chains by ``scripts/torch_kernel_ab.py --k1`` on an older
    tree). Small shapes: seconds, not minutes."""
    for c, nhead in K1_WIDE + K1_JAX_TEST_WIDTHS + K1_NARROW_HEADS:
        x, src, w = _encoder_inputs(gen, 150, 97, c=c, n=2)
        masks = {"x_mask": torch.rand(2, 150, generator=gen, device="cuda") < 0.8,
                 "source_mask": torch.rand(2, 97, generator=gen, device="cuda") < 0.8}
        for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            ws = w if dtype == torch.float32 else {k: (_bf16(v) if v.dim() == 2 else v) for k, v in w.items()}
            packed = pack_encoder_weights(**ws, nhead=nhead, dtype=dtype)
            got = fused_encoder_layer_packed(x, src, packed, **masks)
            again = fused_encoder_layer_packed(x, src, packed, **masks)
            ref = encoder_layer_plain(x, src, **ws, **masks, nhead=nhead, dtype=dtype)
            torch.cuda.synchronize()
            d = (got - ref).abs()
            tol = (TCW32_MAX_ERR, None) if dt == "f32" else (5e-2, 5e-3)
            instance, names = ("tcw_tf32", K1_TCW32_NAMES) if dt == "f32" else ("tcw", K1_TCW_NAMES)
            pms = time_ms(lambda: encoder_layer_plain(x, src, **ws, **masks, nhead=nhead, dtype=dtype), reps=5)
            ms = time_ms(lambda: fused_encoder_layer_packed(x, src, packed, **masks))
            rows, _, _ = device_rows(lambda: fused_encoder_layer_packed(x, src, packed, **masks), reps=3)
            mine = [r for r in rows if _short(r[2]) in names]  # the wrapper also casts the bool masks
            check({_short(r[2]) for r in mine} == set(names)
                  and not {_short(r[2]) for r in rows} & set(K1_NAMES) - set(names),
                  f"K1 {dt} at C = {c} launches {launch_names(rows)}")
            dev = sum(r[0] for r in mine) / 3  # device ms a call
            n_bytes, ops = k1_work(2, 150, 97, c=c, nhead=nhead, w_bytes=dtype.itemsize)
            b = bound(n_bytes, ops, dtype)
            floor = "" if dt == "bf16" else (f", 3xTF32 floor {1e3 * 3 * ops / TF32_OPS_PER_S:.5f} ms "
                                             f"({1e5 * 3 * ops / TF32_OPS_PER_S / dev:.1f} % of it)")
            log(f"[2] K1 {dt} at C = {c}, {nhead} heads, x{tuple(x.shape)} src{tuple(src.shape)} masked: instance "
                f"{packed.instance!r}, max|d| {d.max().item():.3e} (<= {tol[0]:g}), mean|d| {d.mean().item():.3e}"
                f"{'' if tol[1] is None else f' (<= {tol[1]:g})'}, two launches bitwise equal "
                f"{torch.equal(got, again)}; kernel {ms:.3f} ms whole call, device "
                f"{dev:.4f} ms a call of K1's kernels (every launch: {launch_names(rows)}), plain {pms:.3f} ms "
                f"(kernel median of 20, plain of 5); bound {b['bound_ms']:.5f} ms "
                f"({b['bound_by']}, {'67 TFLOP/s f32' if dt == 'f32' else '989 TFLOP/s bf16'}), "
                f"{100 * b['bound_ms'] / dev:.1f} % of it by device time{floor}")
            check(packed.instance == instance and bool(torch.isfinite(got).all()) and d.max().item() <= tol[0]
                  and (tol[1] is None or d.mean().item() <= tol[1]) and torch.equal(got, again),
                  f"K1 {dt} at C = {c}, {nhead} heads disagrees")
            check(ms < pms, f"K1's {dt} chain at C = {c}, {nhead} heads ({ms:.3f} ms) is not faster than its "
                  f"plain version ({pms:.3f})")
    phase2_k1_tcw_realistic(gen)
    phase2_k1_tcw32_realistic(gen)
    phase2_k1_at_256(gen)


def phase2_k1_tcw_realistic(gen) -> None:
    """The bf16 chain at a shape that fills the card: self [4, 4096, C] (256 row
    tiles), against the plain version, bitwise repeatable, with its device time
    by launch and its share of the operations bound; at head width 8 (64 heads
    at C = 512) and at C = 64, 96 and 160 too."""
    for c, nhead in K1_TCW_REALISTIC + K1_HEAD8_REALISTIC + K1_NARROW_REALISTIC:
        x, _, w = _encoder_inputs(gen, 4096, None, c=c, n=4)
        ws = {k: (_bf16(v) if v.dim() == 2 else v) for k, v in w.items()}
        packed = pack_encoder_weights(**ws, nhead=nhead, dtype=torch.bfloat16)
        got = fused_encoder_layer_packed(x, x, packed)
        again = fused_encoder_layer_packed(x, x, packed)
        ref = encoder_layer_plain(x, x, **ws, nhead=nhead, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        d = (got - ref).abs()
        check(packed.instance == "tcw" and bool(torch.isfinite(got).all()) and d.max().item() <= 5e-2
              and d.mean().item() <= 5e-3 and torch.equal(got, again), f"K1 bf16 self [4, 4096, {c}] disagrees")
        del got, again, ref
        ms = time_ms(lambda: fused_encoder_layer_packed(x, x, packed), reps=10)
        pms = time_ms(lambda: encoder_layer_plain(x, x, **ws, nhead=nhead, dtype=torch.bfloat16), reps=5)
        rows, busy, _ = device_rows(lambda: fused_encoder_layer_packed(x, x, packed), reps=3)
        check(only_launches(rows, K1_TCW_NAMES), f"K1 bf16 self [4, 4096, {c}] launches {launch_names(rows)}")
        b = bound(*k1_work(4, 4096, 4096, c=c, nhead=nhead, w_bytes=2), torch.bfloat16)
        log(f"[2] K1 bf16 self [4, 4096, {c}], {nhead} heads (the bf16 chain): max|d| "
            f"{d.max().item():.3e}, mean|d| {d.mean().item():.3e}, two launches bitwise equal; kernel {ms:.4f} ms whole call (median of 10), "
            f"device {busy / 3:.4f} ms a call (every launch: {launch_names(rows)}), plain {pms:.3f} ms (median of 5); "
            f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}, 989 TFLOP/s bf16): {100 * b['bound_ms'] / (busy / 3):.1f} % "
            f"of it by device time, {100 * b['bound_ms'] / ms:.1f} % by whole call")
        del x
        torch.cuda.empty_cache()


def phase2_k1_tcw32_realistic(gen) -> None:
    """The split-TF32 chain at self [4, 4096, C]: against the plain f32 version
    (TF32 off), bitwise repeatable, its device time by launch, its share of the
    f32 bound (67 TFLOP/s) and of the 3xTF32 floor (three products at 495
    TFLOP/s); at C = 64, 96 and 160 too."""
    for c, nhead in K1_TCW_REALISTIC + K1_NARROW_REALISTIC:
        x, _, w = _encoder_inputs(gen, 4096, None, c=c, n=4)
        packed = pack_encoder_weights(**w, nhead=nhead, dtype=torch.float32)
        got = fused_encoder_layer_packed(x, x, packed)
        again = fused_encoder_layer_packed(x, x, packed)
        ref = encoder_layer_plain(x, x, **w, nhead=nhead)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        check(packed.instance == "tcw_tf32" and bool(torch.isfinite(got).all()) and err <= TCW32_MAX_ERR
              and torch.equal(got, again), f"K1 f32 self [4, 4096, {c}] disagrees: {err}")
        del again
        drift = ""
        if c == K1_TCW_REALISTIC[0][0]:  # the float64 layer's distance, at the first width
            exact = encoder_layer_plain(x, x, **w, nhead=nhead, dtype=torch.float64)
            tf32_was = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            single = encoder_layer_plain(x, x, **w, nhead=nhead)
            torch.backends.cuda.matmul.allow_tf32 = tf32_was
            e_kernel, e_plain, e_single = ((y.double() - exact).abs().mean().item() for y in (got, ref, single))
            drift = (f"; mean|y - y64| kernel {e_kernel:.3e} (<= 2x plain f32's), plain f32 {e_plain:.3e}, "
                     f"plain single TF32 {e_single:.3e}")
            check(e_kernel <= 2 * e_plain, f"K1 f32 self [4, 4096, {c}] drifts from float64: {e_kernel} "
                  f"against plain f32's {e_plain}")
            del exact, single
        del got, ref
        ms = time_ms(lambda: fused_encoder_layer_packed(x, x, packed), reps=10)
        pms = time_ms(lambda: encoder_layer_plain(x, x, **w, nhead=nhead), reps=5)
        rows, busy, _ = device_rows(lambda: fused_encoder_layer_packed(x, x, packed), reps=3)
        check(only_launches(rows, K1_TCW32_NAMES), f"K1 f32 self [4, 4096, {c}] launches {launch_names(rows)}")
        n_bytes, ops = k1_work(4, 4096, 4096, c=c, nhead=nhead, w_bytes=4)
        fb = bound(n_bytes, ops, torch.float32)
        floor = 1e3 * 3 * ops / TF32_OPS_PER_S
        dev = busy / 3
        log(f"[2] K1 f32 self [4, 4096, {c}], {nhead} heads (the split-TF32 chain): max|d| {err:.3e} "
            f"(<= {TCW32_MAX_ERR:g}), two launches bitwise equal{drift}; kernel {ms:.4f} ms whole call (median of 10), "
            f"device {dev:.4f} ms a call (every launch: {launch_names(rows)}), plain {pms:.3f} ms (median of 5); f32 "
            f"bound {fb['bound_ms']:.4f} ms ({fb['bound_by']}, 67 TFLOP/s): {100 * fb['bound_ms'] / dev:.1f} % of it by "
            f"device time; 3xTF32 floor {floor:.4f} ms (495 TFLOP/s): {100 * floor / dev:.1f} %")
        del x
        torch.cuda.empty_cache()


def phase2_k1_at_256(gen) -> None:
    """K1 at (256, 8), self [16, 7000, 256]: with bf16 operands the bf16 chain
    "tcw" (forced pack, measured and not routed) beside the routed "tc", whole
    calls in turns (routed, wide, wide, routed) and device time; with f32
    operands the routed split-TF32 chain "tcw_tf32" against the plain f32
    version, bitwise repeatable, by kernel name, its mean distance to the layer
    in float64 within 2x plain f32's, its whole call and device time."""
    x, _, w = _encoder_inputs(gen, 7000, None, n=B)
    wb = {k: (_bf16(v) if v.dim() == 2 else v) for k, v in w.items()}
    _, ops = k1_work(B, 7000, 7000)
    routed = pack_encoder_weights(**wb, nhead=8, dtype=torch.bfloat16)
    check(routed.instance == "tc", f"K1 bf16 at (256, 8) routes to {routed.instance}")
    wide = _forced_pack(routed, wb, "tcw")
    ref = encoder_layer_plain(x, x, **wb, nhead=8, dtype=torch.bfloat16)
    res = {}
    for tag, packed, kernel_names in (("routed", routed, K1_TC_NAMES), ("wide", wide, K1_TCW_NAMES)):
        got = fused_encoder_layer_packed(x, x, packed)
        torch.cuda.synchronize()
        d = (got - ref).abs()
        check(d.max().item() <= 5e-2 and d.mean().item() <= 5e-3 and bool(torch.isfinite(got).all()),
              f"K1 bf16 {packed.instance} at (256, 8) disagrees")
        rows, busy, _ = device_rows(lambda: fused_encoder_layer_packed(x, x, packed), reps=3)
        check(only_launches(rows, kernel_names), f"K1 {packed.instance} launches {launch_names(rows)}")
        res[tag] = {"max": d.max().item(), "dev": busy / 3, "ms": []}
        del got
    for tag in ("routed", "wide", "wide", "routed"):
        packed = routed if tag == "routed" else wide
        res[tag]["ms"].append(time_ms(lambda: fused_encoder_layer_packed(x, x, packed)))
    bf = 1e3 * ops / PEAK_OPS_PER_S[torch.bfloat16]
    log(f"[2] K1 bf16 at (256, 8), self [{B}, 7000, 256]: 'tc' (routed) whole call "
        f"{res['routed']['ms'][0]:.4f} / {res['routed']['ms'][1]:.4f} ms, device {res['routed']['dev']:.4f} ms, "
        f"max|d| {res['routed']['max']:.3e}; 'tcw' (forced pack) whole call {res['wide']['ms'][0]:.4f} / "
        f"{res['wide']['ms'][1]:.4f} ms, device {res['wide']['dev']:.4f} ms, max|d| {res['wide']['max']:.3e} "
        f"(medians of 20 in turns: routed, wide, wide, routed); bf16 bound {bf:.4f} ms: "
        f"{100 * bf / res['routed']['dev']:.1f} % / {100 * bf / res['wide']['dev']:.1f} % of it")
    del ref, wb, routed, wide
    torch.cuda.empty_cache()
    # f32: the chain is the routed instance at this width
    packed = pack_encoder_weights(**w, nhead=8, dtype=torch.float32)
    check(packed.instance == "tcw_tf32", f"K1 f32 at (256, 8) routes to {packed.instance}")
    got = fused_encoder_layer_packed(x, x, packed)
    again = fused_encoder_layer_packed(x, x, packed)
    ref = encoder_layer_plain(x, x, **w, nhead=8)
    exact = encoder_layer_plain(x, x, **w, nhead=8, dtype=torch.float64)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    e_kernel, e_plain = ((y.double() - exact).abs().mean().item() for y in (got, ref))
    same = torch.equal(got, again)
    del got, again, ref, exact
    torch.cuda.empty_cache()
    ms = time_ms(lambda: fused_encoder_layer_packed(x, x, packed))
    rows, busy, _ = device_rows(lambda: fused_encoder_layer_packed(x, x, packed), reps=3)
    floor = 1e3 * 3 * ops / TF32_OPS_PER_S
    log(f"[2] K1 f32 at (256, 8), self [{B}, 7000, 256]: {packed.instance!r} (routed): max|d| {err:.3e} "
        f"(<= {TCW32_MAX_ERR:g}), two launches bitwise equal {same}; mean|y - y64| kernel {e_kernel:.3e} "
        f"(<= 2x plain f32's), plain f32 {e_plain:.3e} ({e_kernel / e_plain:.2f}x); whole call {ms:.4f} ms "
        f"(median of 20), device {busy / 3:.4f} ms a call (every launch: {launch_names(rows)}); 3xTF32 floor "
        f"{floor:.4f} ms: {100 * floor / (busy / 3):.1f} % of it")
    check(err <= TCW32_MAX_ERR and same and e_kernel <= 2 * e_plain,
          f"K1 f32 at (256, 8) disagrees: max|d| {err}, float64 distance {e_kernel} against plain f32's {e_plain}")
    check(only_launches(rows, K1_TCW32_NAMES), f"K1 f32 at (256, 8) launches {launch_names(rows)}")
    del x
    torch.cuda.empty_cache()


K2_PREVIOUS_MS = 24.138  # bf16 on the CUDA-core tile at the recorded shape (NVIDIA H100 80GB HBM3, 700.00 W)


def phase2_k2(gen) -> dict:
    f0 = torch.randn(B, 7000, 256, generator=gen, device="cuda")
    f1 = torch.randn(B, 4096, 256, generator=gen, device="cuda")
    worst, rec = 0.0, {}
    for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        got = dual_softmax_rowcol_stats(f0, f1, 0.08, dtype=dtype)
        again = dual_softmax_rowcol_stats(f0, f1, 0.08, dtype=dtype)
        a0 = (f0 / 16.0).to(dtype)
        a1 = (f1 / 16.0).to(dtype)
        ref = rowcol_stats_plain(a0, a1, 1.0 / (0.08 + 1e-4))
        torch.cuda.synchronize()
        lse = max((got[k] - ref[k]).abs().max().item() for k in ("row_lse", "col_lse"))
        row_ag = (got["row_best_j"] == ref["row_best_j"]).float().mean().item()
        col_ag = (got["col_best_p"] == ref["col_best_p"]).float().mean().item()
        same = all(torch.equal(got[k], again[k]) for k in got)
        log(f"[2] K2 {dt} f0{tuple(f0.shape)} f1{tuple(f1.shape)}: LSE max|d| {lse:.3e} (<= 1e-3), "
            f"row argmax agree {row_ag:.6f}, col argmax agree {col_ag:.6f} (>= 0.999), two launches "
            f"bitwise equal {same}")
        check(lse <= 1e-3 and row_ag >= 0.999 and col_ag >= 0.999 and same, f"K2 {dt} disagrees")
        if dt == "f32":
            worst = lse
        ms = time_ms(lambda: dual_softmax_rowcol_stats(f0, f1, 0.08, dtype=dtype))
        pms = time_ms(lambda: rowcol_stats_plain(a0, a1, 1.0 / (0.08 + 1e-4)))
        rows, busy, _ = device_rows(lambda: dual_softmax_rowcol_stats(f0, f1, 0.08, dtype=dtype), reps=5)
        before = f" ({K2_PREVIOUS_MS} ms on the CUDA-core tile)" if dt == "bf16" else ""
        log(f"[2] K2 {dt}: kernel {ms:.3f} ms{before}, plain {pms:.3f} ms (median of 20); device time by "
            f"launch: {launch_names(rows)} ({busy / 5:.3f} ms a call, torch.profiler, 5 calls)")
        names = K2_TC_NAMES if dt == "bf16" else K2_TF32_NAMES
        check(only_launches(rows, names), f"K2 {dt} launches something besides {names}")
        rec[dt] = (ms, pms)
        del got, again, ref
    ms, pms = rec["bf16"]
    check(ms < pms, f"K2's bf16 instance ({ms:.3f} ms) is not faster than its plain version ({pms:.3f} ms)")
    p, l, c = f0.shape[1], f1.shape[1], f0.shape[2]
    n_bytes = B * (p + l) * c * 4 + B * (p + l) * 4 * 4  # f32 features in; LSE, value, index rows/cols out
    b = bound(n_bytes, 2 * B * p * l * c, torch.bfloat16)  # one similarity product
    fb = bound(n_bytes, 2 * B * p * l * c, torch.float32)
    n_exp = 2 * B * p * l  # the LSE pass: one exponential a row and one a column, per element
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"[2] K2 bf16 bound {b['bound_ms']:.4f} ms ({b['bound_by']}; f32 instance {fb['bound_ms']:.4f} ms at "
        f"67 TFLOP/s); its {n_exp / 1e9:.3f} G exponentials at 16 a clock per SM take "
        f"{1e3 * n_exp / (16 * sm_count * 1.755e9):.4f} ms at 1.755 GHz; no single PyTorch call computes "
        f"the dual-softmax statistics")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": pms, **b, "library_ms": None}


# K2 above 576 channels, on the tensor cores at any width (csrc/sim_tile_wide.cuh): each
# instance's operand packs, both passes and their merges
K2_WIDE_NAMES = {
    "bf16": ("pack_wide_bf16_kernel", "lse_wide_bf16_kernel", "col_lse_reduce", "argmax_wide_bf16_kernel",
             "col_argmax_reduce"),
    "f32": ("pack_tf32_operand_kernel", "pack_tf32_hilo_kernel", "lse_wide_tf32x3_kernel", "col_lse_reduce",
            "argmax_wide_tf32x3_kernel", "col_argmax_reduce"),
}
K2_WIDE_LOAD = (640, 1024, 2048)  # C at [16, 7000] x [16, 4096]
K2_CC_PREVIOUS_MS = 1.6281  # f32 at [2,1000]x[2,700]x640 on the CUDA-core tile, its last run (NVIDIA H100 80GB HBM3, 700.00 W)


def k2_two_products(n: int, p: int, l: int, c: int, dt: str) -> float:
    """The least ms of K2's two similarity products: at 989 TFLOP/s in bf16, as
    three TF32 products each at 495 TFLOP/s (the 3xTF32 floor) in f32."""
    ops = 2 * 2 * n * p * l * c
    return 1e3 * (ops / PEAK_OPS_PER_S[torch.bfloat16] if dt == "bf16" else 3 * ops / TF32_OPS_PER_S)


def _k2_wide_case(f0, f1, col_add, dt: str, reps: int, prof_reps: int):
    """K2 at one shape in one dtype against its plain version on the same
    values: (max|d| of LSEs and best values, least argmax agreement, two launches
    bitwise equal, whole-call ms, plain ms, device rows, device ms a call)."""
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    scale = f0.shape[-1] ** -0.5
    a0, a1 = (f0 * scale).to(dtype), (f1 * scale).to(dtype)
    call = lambda: dual_softmax_rowcol_stats(f0, f1, 0.08, col_add=col_add, dtype=dtype)  # noqa: E731
    plain = lambda: rowcol_stats_plain(a0, a1, 1 / (0.08 + 1e-4), None, col_add)  # noqa: E731
    got, again, ref = call(), call(), plain()
    torch.cuda.synchronize()
    err = max((got[k] - ref[k]).abs().max().item() for k in ("row_lse", "col_lse", "row_best_val", "col_best_val"))
    agree = min((got[k] == ref[k]).float().mean().item() for k in ("row_best_j", "col_best_p"))
    same = all(torch.equal(got[k], again[k]) for k in got)
    del got, again, ref
    ms, pms = time_ms(call, reps=reps), time_ms(plain, reps=max(3, reps // 4))
    rows, busy, _ = device_rows(call, reps=prof_reps)
    return err, agree, same, ms, pms, rows, busy / prof_reps


def phase2_k2_wide(gen, smi: str) -> None:
    """K2 above 576 channels on the channel-streaming tensor-core tile, both
    instances ("wide_bf16": bf16 operands; "wide_tf32": f32 in split TF32):
    ragged [2,1000]x[2,700] at C = 640 and 1000 with a column mask, and the
    shape at load [16,7000]x[16,4096] at C = 640 / 1024 / 2048 (no mask): LSEs
    and best values within 1e-3 of the plain version on the same values,
    argmaxes agreeing on >= 99.9 %, two launches bitwise equal, exactly the
    instance's kernels by name; whole call, device time by launch, plain
    version, bound and share. Then the mean row-LSE distance to float64 at
    C = 2048 beside the plain version's (wide_tf32 within 2x plain f32's), and
    the match set of the fused selection on planted features at C = 1024 in
    bf16 against the plain version's (Jaccard >= 0.98, as phase 3)."""
    n, p, l = 2, 1000, 700
    for c in (640, 1000):
        f0 = torch.randn(n, p, c, generator=gen, device="cuda")
        f1 = torch.randn(n, l, c, generator=gen, device="cuda")
        col_add = torch.where(torch.rand(n, l, generator=gen, device="cuda") > 0.1, 0.0, -1e9)
        for dt in ("bf16", "f32"):
            err, agree, same, ms, pms, rows, dev = _k2_wide_case(f0, f1, col_add, dt, 20, 5)
            b = k2_two_products(n, p, l, c, dt)
            before = f"; the CUDA-core tile took {K2_CC_PREVIOUS_MS} ms (f32)" if c == 640 else ""
            log(f"[2] K2 wide {dt} [{n},{p}]x[{n},{l}]x{c} masked: LSE and best values max|d| {err:.3e} (<= 1e-3), "
                f"argmax agree {agree:.6f} (>= 0.999), two launches bitwise equal {same}; kernel {ms:.4f} ms whole "
                f"call{before}, device {dev:.4f} ms a call ({launch_names(rows)}), plain {pms:.4f} ms; bound "
                f"{b:.5f} ms (two products, operations), {100 * b / dev:.1f} % of it by device time")
            check(err <= 1e-3 and agree >= 0.999 and same, f"K2 wide {dt} at C = {c} disagrees")
            check(only_launches(rows, K2_WIDE_NAMES[dt]), f"K2 wide {dt} at C = {c} launches {launch_names(rows)}")
        del f0, f1
    for c in K2_WIDE_LOAD:
        f0 = torch.randn(B, 7000, c, generator=gen, device="cuda")
        f1 = torch.randn(B, 4096, c, generator=gen, device="cuda")
        zeros = torch.zeros(B, 4096, device="cuda")
        for dt in ("bf16", "f32"):
            err, agree, same, ms, pms, rows, dev = _k2_wide_case(f0, f1, zeros, dt, 10, 3)
            b = k2_two_products(B, 7000, 4096, c, dt)
            log(f"[2] K2 wide {dt} [{B},7000]x[{B},4096]x{c}: LSE and best values max|d| {err:.3e} (<= 1e-3), "
                f"argmax agree {agree:.6f}, bitwise {same}; kernel {ms:.3f} ms whole call, device {dev:.3f} ms a "
                f"call ({launch_names(rows)}), plain {pms:.3f} ms; bound {b:.3f} ms ("
                f"{'two products at 989 TFLOP/s' if dt == 'bf16' else 'the 3xTF32 floor of two products'}), "
                f"{100 * b / dev:.1f} % of it by device time; on {smi}")
            check(err <= 1e-3 and agree >= 0.999 and same, f"K2 wide {dt} at [{B},7000]x[{B},4096]x{c} disagrees")
            check(only_launches(rows, K2_WIDE_NAMES[dt]), f"K2 wide {dt} at C = {c} launches {launch_names(rows)}")
        del f0, f1
        torch.cuda.empty_cache()
    # the mean distance of row_lse to float64 at C = 2048, beside the plain version's
    c = 2048
    f0 = torch.randn(n, p, c, generator=gen, device="cuda")
    f1 = torch.randn(n, l, c, generator=gen, device="cuda")
    col_add = torch.where(torch.rand(n, l, generator=gen, device="cuda") > 0.1, 0.0, -1e9)
    dist = {}
    for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        a0, a1 = (f0 * c ** -0.5).to(dtype), (f1 * c ** -0.5).to(dtype)
        sim = torch.einsum("bpc,blc->bpl", a0.double(), a1.double()) / (0.08 + 1e-4) + col_add.double()[:, None, :]
        lse64 = torch.logsumexp(sim, dim=2)
        got = dual_softmax_rowcol_stats(f0, f1, 0.08, col_add=col_add, dtype=dtype)["row_lse"]
        ref = rowcol_stats_plain(a0, a1, 1 / (0.08 + 1e-4), None, col_add)["row_lse"]
        dist[dt] = tuple((x.double() - lse64).abs().mean().item() for x in (got, ref))
    log(f"[2] K2 wide at [{n},{p}]x[{n},{l}]x{c}: mean |row_lse - float64| wide_bf16 {dist['bf16'][0]:.3e} "
        f"(plain bf16 values, f32 sums {dist['bf16'][1]:.3e}), wide_tf32 {dist['f32'][0]:.3e} (plain f32 "
        f"{dist['f32'][1]:.3e}; <= 2x)")
    check(dist["f32"][0] <= 2 * dist["f32"][1], "K2 wide_tf32 drifts from float64 beyond 2x plain f32")
    # the match set on planted features at C = 1024 in bf16: rows 3i planted on columns 2i
    c, p = 1024, 2000
    f1 = torch.randn(n, 4096, c, generator=gen, device="cuda")
    f0 = torch.randn(n, p, c, generator=gen, device="cuda")
    rows_ = torch.arange(0, p, 3, device="cuda")
    f0[:, rows_] = f1[:, 2 * rows_ // 3] + 0.3 * torch.randn(n, len(rows_), c, generator=gen, device="cuda")
    sel = dict(temperature=0.08, grid_hw=(64, 64), thr=0.0, border_rm=2, k=1024, dtype=torch.bfloat16)
    kern = fused_select_topk_matches(f0, f1, **sel)
    plain = fused_select_topk_matches(f0.cpu(), f1.cpu(), **sel)
    sets = [[set(zip(m.i_ids[f][m.mask[f]].tolist(), m.j_ids[f][m.mask[f]].tolist())) for f in range(n)]
            for m in (kern, plain)]
    jacc = [len(a & b) / max(len(a | b), 1) for a, b in zip(*sets)]
    log(f"[2] K2 wide_bf16 fused selection on planted features [{n},{p}]x[{n},4096]x{c}: matches "
        f"{[len(x) for x in sets[0]]}, plain {[len(x) for x in sets[1]]}, jaccard {[round(j, 4) for j in jacc]} "
        f"(>= 0.98)")
    check(min(jacc) >= 0.98 and all(sets[0]), "K2 wide_bf16 changes the match set")


TF32_OPS_PER_S = 495e12  # dense TF32 tensor cores (NVIDIA's data sheet, H100 SXM)
K1_F32_PREVIOUS_MS = 7.763  # self [16, 7000, 256] on the CUDA cores (NVIDIA H100 80GB HBM3, 700.00 W)
K2_F32_PREVIOUS = {16: 24.320, 1: 3.32, 4: 7.68}  # ms by batch, CUDA-core tile (same card and limit)


def k1_work(n: int, l: int, s: int, c: int = 256, nhead: int = 8, w_bytes: int = 4):
    """(bytes, operations) of one K1 layer: x [n, l, c] attends to source
    [n, s, c]; 6 projections and the FFN (16 l c^2 + 4 s c^2), K'^T[V|1] and
    the attention products (2 (l + s) c (hd + 1)); x and source in, y out, the
    weights and LayerNorms once."""
    hd = c // nhead
    ops = n * (16 * l * c * c + 4 * s * c * c + 2 * (l + s) * c * (hd + 1))
    return 4 * n * (2 * l + s) * c + 10 * c * c * w_bytes + 4 * c * 4, ops


def phase2_f32(gen) -> None:
    """K1's and K2's f32 instances (split TF32 on the tensor cores) at the
    main shape [16, ...], at batch 1 (a tracking frame) and K2 at the train
    shape [4, ...]: time, launches by name, f32 bound and 3xTF32 floor."""
    # K1: the query step's four layer shapes; a tracking frame runs each three times
    k1_total = {}
    for n in (B, 1):
        for tag, l, s_ in (("self-7000", 7000, None), ("self-4096", 4096, None),
                           ("cross-7000", 7000, 4096), ("cross-4096", 4096, 7000)):
            if n == B and tag != "self-7000":
                continue
            x, src, w = _encoder_inputs(gen, l, s_, n=n)
            packed = pack_encoder_weights(**w, nhead=8, dtype=torch.float32)
            check(packed.instance == "tcw_tf32", f"K1 f32 at C = 256 takes instance {packed.instance}")
            ms = time_ms(lambda: fused_encoder_layer_packed(x, src, packed))
            pms = time_ms(lambda: encoder_layer_plain(x, src, **w, nhead=8), reps=5)
            rows, busy, _ = device_rows(lambda: fused_encoder_layer_packed(x, src, packed), reps=5)
            n_bytes, ops = k1_work(n, l, src.shape[1])
            fb = bound(n_bytes, ops, torch.float32)
            floor = 1e3 * 3 * ops / TF32_OPS_PER_S
            prev = f" ({K1_F32_PREVIOUS_MS} ms on the CUDA cores)" if n == B else ""
            log(f"[2] K1 f32 {tag} x[{n}, {l}, 256]: kernel {ms:.3f} ms{prev}, plain {pms:.3f} ms; f32 bound "
                f"{fb['bound_ms']:.4f} ms ({fb['bound_by']}, 67 TFLOP/s), 3xTF32 floor {floor:.4f} ms "
                f"(495 TFLOP/s); device {busy / 5:.4f} ms a call, launches {launch_names(rows)}")
            check(only_launches(rows, K1_TCW32_NAMES), f"K1 f32 launches something besides {K1_TCW32_NAMES}: "
                  f"{launch_names(rows)}")
            k1_total[(n, tag)] = (ms, busy / 5, sum(r[1] for r in rows) / 5)
    frame = [3 * sum(v[i] for (n, _), v in k1_total.items() if n == 1) for i in range(3)]
    log(f"[2] K1 f32 for a tracking frame (3 x the four batch-1 shapes, 12 layer calls): {frame[0]:.3f} ms whole "
        f"calls, {frame[1]:.3f} ms device time, {frame[2]:.0f} kernel launches")
    # K2: the query step's selection at batch 16 and 1, training's at batch 4
    for n in (B, 1, TRAIN_B):
        f0 = torch.randn(n, 7000, 256, generator=gen, device="cuda")
        f1 = torch.randn(n, 4096, 256, generator=gen, device="cuda")
        got = dual_softmax_rowcol_stats(f0, f1, 0.08)
        again = dual_softmax_rowcol_stats(f0, f1, 0.08)
        ref = rowcol_stats_plain(f0 / 16.0, f1 / 16.0, 1.0 / (0.08 + 1e-4))
        torch.cuda.synchronize()
        lse = max((got[k] - ref[k]).abs().max().item() for k in ("row_lse", "col_lse", "row_best_val",
                                                                 "col_best_val"))
        agree = min((got[k] == ref[k]).float().mean().item() for k in ("row_best_j", "col_best_p"))
        same = all(torch.equal(got[k], again[k]) for k in got)
        ms = time_ms(lambda: dual_softmax_rowcol_stats(f0, f1, 0.08))
        pms = time_ms(lambda: rowcol_stats_plain(f0 / 16.0, f1 / 16.0, 1.0 / (0.08 + 1e-4)), reps=5)
        rows, busy, _ = device_rows(lambda: dual_softmax_rowcol_stats(f0, f1, 0.08), reps=3)
        ops = 2 * n * 7000 * 4096 * 256
        fb = bound(n * (7000 + 4096) * 256 * 4 + n * (7000 + 4096) * 16, ops, torch.float32)
        log(f"[2] K2 f32 [{n},7000]x[{n},4096]x256: kernel {ms:.3f} ms ({K2_F32_PREVIOUS[n]} ms on the CUDA "
            f"cores), plain {pms:.3f} ms; f32 bound {fb['bound_ms']:.4f} ms (67 TFLOP/s, one product), "
            f"3xTF32 floor {1e3 * 3 * ops / TF32_OPS_PER_S:.4f} ms (one product; the two passes take two); "
            f"LSE max|d| {lse:.3e} (<= 1e-3), argmax agree {agree:.6f} (>= 0.999), two launches bitwise "
            f"equal {same}; launches {launch_names(rows)} ({busy / 3:.3f} ms a call)")
        check(lse <= 1e-3 and agree >= 0.999 and same, f"K2 f32 at batch {n} disagrees")
        check(only_launches(rows, K2_TF32_NAMES), f"K2 f32 launches something besides {K2_TF32_NAMES}")
        if n == 1:  # the resident tile's distance to float64 at a tracking frame's shape
            lse64 = torch.logsumexp(torch.einsum("bpc,blc->bpl", f0.double() / 16.0, f1.double() / 16.0)
                                    / (0.08 + 1e-4), dim=2)
            kernel, plain = ((r["row_lse"].double() - lse64).abs().mean().item() for r in (got, ref))
            log(f"[2] K2 f32 [1,7000]x[1,4096]x256: mean |row_lse - float64| kernel {kernel:.3e}, plain f32 "
                f"{plain:.3e} ({kernel / plain:.2f}x, <= 2x)")
            check(kernel <= 2 * plain, f"K2's f32 resident tile drifts from float64: {kernel} against {plain}")
            del lse64
        del f0, f1, got, again, ref


K3_PREVIOUS_MS = 0.074  # bf16 whole call at the query shape, one block a window (NVIDIA H100 80GB HBM3, 700.00 W)


def phase2_k3(gen) -> dict:
    """K3 at the query step's shape (both dtypes) and at the train shape in
    f32, ids at the grid's four corners (windows reaching off the map) and out
    of range (zero windows): exact; whole call and device time beside
    index_select on precomputed indices."""
    rec = {}
    for tag, n, k in (("query", B, 512), ("train", TRAIN_B, 1228)):
        feat = torch.randn(n, 256, 256, 128, generator=gen, device="cuda")
        ids = torch.randint(0, 64 * 64, (n, k), generator=gen, device="cuda", dtype=torch.int32)
        ids[:, :8] = torch.tensor([-1, -7, 4096, 5000, 0, 63, 4032, 4095], dtype=torch.int32)
        for dt, f in (("f32", feat), ("bf16", feat.to(torch.bfloat16))):
            if tag == "train" and dt == "bf16":
                continue  # training gathers its f32 map
            got = window_gather(f, ids, (64, 64), 4, 5)
            ref = window_gather_plain(f, ids, (64, 64), 4, 5)
            torch.cuda.synchronize()
            check(got.shape == (n, k, 25, 128), f"K3 shape {tuple(got.shape)}")
            equal = torch.equal(got, ref)
            zeros = bool((got[:, :4] == 0).all())
            corners_cut = bool((got[:, 4:8].reshape(n, 4, 5, 5, 128)[:, 0, :2] == 0).all())
            log(f"[2] K3 {tag} {dt} feat{tuple(f.shape)} -> {tuple(got.shape)}: exact {equal}, zero windows for "
                f"out-of-range ids {zeros}, off-map taps of a corner window zero {corners_cut}")
            check(equal and zeros and corners_cut, f"K3 {tag} {dt} disagrees")
            ms = time_ms(lambda: window_gather(f, ids, (64, 64), 4, 5))
            pms = time_ms(lambda: window_gather_plain(f, ids, (64, 64), 4, 5))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):  # the host's share of a call: launches queue up, nothing waits
                window_gather(f, ids, (64, 64), 4, 5)
            host_us = 1e6 * (time.perf_counter() - t0) / 200
            rows, busy, _ = device_rows(lambda: window_gather(f, ids, (64, 64), 4, 5), reps=10)
            check({_short(r[2]) for r in rows} <= set(K3_NAMES), f"K3 launches {launch_names(rows)}")
            dev = busy / sum(r[1] for r in rows)  # device ms a launch (the profiler may miss the first)
            flat, valid = _window_taps(ids, (256, 256), (64, 64), 4, 5)
            table, idx = index_select_table(f, flat, valid)
            check(torch.equal(torch.index_select(table, 0, idx).view_as(got), ref), "K3 yardstick differs")
            lms = time_ms(lambda: torch.index_select(table, 0, idx))
            b = bound(gather_bytes(flat, valid, 256 * 256, 128 * f.element_size(), got, ids.numel() * 4), 0, f.dtype)
            before = f" ({K3_PREVIOUS_MS} ms in the one-block-a-window design)" if (tag, dt) == ("query", "bf16") else ""
            log(f"[2] K3 {tag} {dt}: kernel {ms:.4f} ms whole call{before}, device {dev:.4f} ms a launch "
                f"(torch.profiler, 10 calls), host {host_us:.1f} us a call (200 calls queued), plain {pms:.3f} ms, index_select with precomputed indices "
                f"{lms:.4f} ms (median of 20); bound {b['bound_ms']:.4f} ms ({b['bound_by']}): "
                f"{100 * b['bound_ms'] / ms:.0f} % of it whole call, {100 * b['bound_ms'] / dev:.0f} % device")
            rec[(tag, dt)] = {"ms": ms, "plain_ms": pms, "library_ms": lms, **b}
            del table, idx, got, ref
        del feat
    return {"max_abs_err": 0.0, **rec[("query", "bf16")]}


def host_us(fn, calls: int = 200) -> float:
    """The host's share of a call, in us: `calls` calls queued with nothing
    waiting on the device."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return us


K6_OFFSETS = (2, 4, 8)  # bytes a map view starts past an alignment


def k6_case(where: str, tag: str, f: torch.Tensor, r0: torch.Tensor, c0: torch.Tensor, win: int,
            call=None) -> dict:
    """K6 at one instance: bitwise against its plain version at corners
    (r0, c0), also on copies of the map that start 2, 4 and 8 bytes past an
    alignment (those the dtype allows), its last 16 slots (off the map) zero,
    the index_select yardstick equal; then the whole call, device time (the
    profiler, K6's launch alone), host time a call, the plain version and
    index_select on precomputed indices, beside the bytes bound. ``call``
    (default ``patch_gather(f, r0, c0, win)``) is the caller's own entry."""
    n, h, w, c = f.shape
    call = call or (lambda: patch_gather(f, r0, c0, win))
    got, ref = call(), patch_gather_plain(f, r0, c0, win)
    flat, valid = patch_taps(r0, c0, (h, w), win)
    table, idx = index_select_table(f, flat, valid)
    torch.cuda.synchronize()
    equal = torch.equal(got, ref) and torch.equal(torch.index_select(table, 0, idx).view_as(got), ref)
    zero = bool((got[:, -16:] == 0).all())
    size = f.element_size()
    offsets = [off for off in K6_OFFSETS if off % size == 0]
    for off in offsets:
        buf = torch.empty(off // size + f.numel(), dtype=f.dtype, device="cuda")
        view = buf[off // size:].view(f.shape)
        view.copy_(f)
        check(view.data_ptr() % 16 == off, f"K6 {tag}: a view {view.data_ptr() % 16} bytes off, not {off}")
        equal = equal and torch.equal(patch_gather(view, r0, c0, win), ref)
        del buf, view
    torch.cuda.synchronize()
    log(f"[{where}] K6 {tag} feat{tuple(f.shape)} -> {tuple(got.shape)}: bitwise equal to the plain version and "
        f"the yardstick {equal} (also maps {', '.join(map(str, offsets))} bytes past an alignment), "
        f"off-map slots zero {zero}")
    check(equal and zero and got.shape == (n, r0.shape[1], win * win, c), f"K6 {tag} disagrees")
    ms = time_ms(call)
    pms = time_ms(lambda: patch_gather_plain(f, r0, c0, win))
    lms = time_ms(lambda: torch.index_select(table, 0, idx))
    hus = host_us(call)
    rows, busy, _ = device_rows(call, reps=5)
    check(only_launches(rows, K6_NAMES), f"K6 {tag} launched {launch_names(rows)}")
    dev = busy / sum(r[1] for r in rows)  # a launch, over those the profiler kept
    index_bytes = 2 * r0.numel() * r0.element_size()
    b = bound(gather_bytes(flat, valid, h * w, c * size, got, index_bytes), 0, f.dtype)
    log(f"[{where}] K6 {tag} ({c * size} bytes a pixel, {r0.dtype} corners): whole call {ms:.4f} ms, device "
        f"{dev:.4f} ms, host {hus:.1f} us a call (200 queued), plain {pms:.3f} ms, index_select with "
        f"precomputed indices {lms:.4f} ms (medians of 20); bound {b['bound_ms']:.4f} ms ({b['bound_by']}), "
        f"{100 * b['bound_ms'] / dev:.0f} % of it by device time, {100 * b['bound_ms'] / ms:.0f} % whole call")
    del got, ref, table, idx, flat, valid
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": pms, "library_ms": lms, **b}


# pixels that are not a multiple of 16 bytes: (dtype, C); bf16 C = 196 is the sparse FPN's pin map
NARROW_PIXELS = ((torch.bfloat16, 196), (torch.bfloat16, 130), (torch.bfloat16, 33),
                 (torch.float32, 130), (torch.float32, 33))
# each instance of K3 by the name of its launch
K3_INSTANCE_NAMES = {"vector": ("window_gather_kernel",), "span": ("window_span_kernel",)}


def k3_record(where: str, tag: str, feat: torch.Tensor, ids: torch.Tensor) -> dict:
    """K3 on one map (windows of 5 at stride 4) through window_gather, the
    instance it routes to: bitwise against its plain version
    and index_select on precomputed indices, the launch by name; whole call,
    device time a launch (the profiler), host time a call (200 queued), the
    plain version, index_select, and the bytes bound."""
    n, h, w, c = feat.shape
    grid, size = (h // 4, w // 4), c * feat.element_size()
    inst = window_instance(size, feat.data_ptr())
    call = lambda: window_gather(feat, ids, grid, 4, 5)  # noqa: E731
    plain = lambda: window_gather_plain(feat, ids, grid, 4, 5)  # noqa: E731
    got, ref = call(), plain()
    flat, valid = _window_taps(ids, (h, w), grid, 4, 5)
    table, idx = index_select_table(feat, flat, valid)
    torch.cuda.synchronize()
    equal = torch.equal(got, ref) and torch.equal(torch.index_select(table, 0, idx).view_as(got), ref)
    check(equal, f"K3 {tag} disagrees with its plain version")
    ms, pms, lms = time_ms(call), time_ms(plain), time_ms(lambda: torch.index_select(table, 0, idx))
    hus = host_us(call)
    rows, busy, _ = device_rows(call, reps=5)
    check(only_launches(rows, K3_INSTANCE_NAMES[inst]), f"K3 {tag} launched {launch_names(rows)}")
    dev = busy / sum(r[1] for r in rows)  # a launch, over those the profiler kept
    b = bound(gather_bytes(flat, valid, h * w, size, got, ids.numel() * 4), 0, feat.dtype)
    log(f"[{where}] K3 {tag} ({size} bytes a pixel, {inst} instance) feat{tuple(feat.shape)} -> {tuple(got.shape)}: "
        f"bitwise equal to the plain version and index_select {equal}; whole call {ms:.4f} ms, device {dev:.4f} ms "
        f"a launch ({launch_names(rows)}), host {hus:.1f} us a call (200 queued), plain {pms:.3f} ms, index_select "
        f"with precomputed indices {lms:.4f} ms (medians of 20); bound {b['bound_ms']:.4f} ms ({b['bound_by']}), "
        f"{100 * b['bound_ms'] / dev:.0f} % of it by device time, {100 * b['bound_ms'] / ms:.0f} % whole call")
    del got, ref, table, idx
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": pms, "library_ms": lms, "device_ms": dev, "host_us": hus, **b}


def k4_record(where: str, tag: str, grad: torch.Tensor, ids: torch.Tensor, hw) -> dict:
    """K4 (windows of 5 at stride 4, int32 ids) through window_scatter: within
    7a's tolerances of its plain version (index_add_ sums in another order),
    two calls bitwise equal, the two launches by name; whole call, device time
    of the index launch and the sum apart (the profiler), host time a call
    (200 queued), the plain version, zero_ + index_add_ on precomputed rows
    (index_add_ alone beside it), and the bound: the valid taps read, K4's own
    index arrays (ids, order, cell_start), the map written; one add a tap
    element."""
    n, k, taps, c = grad.shape
    h, w = hw
    grid, size = (h // 4, w // 4), c * grad.element_size()
    call = lambda: window_scatter(grad, ids, grid, 4, 5, hw)  # noqa: E731
    plain = lambda: window_scatter_plain(grad, ids, grid, 4, 5, hw)  # noqa: E731
    got, again, ref = call(), call(), plain()
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    same = torch.equal(got, again)
    tol = 1e-4 if grad.dtype == torch.float32 else 6e-2  # f32 summation order / one bf16 rounding of |sum| <= ~8
    check(err <= tol and same, f"K4 {tag} disagrees or is not deterministic")
    flat, valid = _window_taps(ids, hw, grid, 4, 5)
    rows = (flat + (h * w) * torch.arange(n, device="cuda")[:, None])[valid]
    src = grad.reshape(n, k * taps, c)[valid]
    acc = torch.zeros(n * h * w, c, dtype=grad.dtype, device="cuda")
    ms, pms = time_ms(call), time_ms(plain)
    bare = time_ms(lambda: acc.index_add_(0, rows, src))
    lms = time_ms(lambda: acc.zero_().index_add_(0, rows, src))
    hus = host_us(call)
    prow, _, _ = device_rows(call, reps=5)
    names = ("scatter_index_kernel", "window_sum_kernel")
    check(only_launches(prow, names), f"K4 {tag} launched {launch_names(prow)}")
    per = {_short(r[2]): r[0] / r[1] for r in prow}  # device ms a launch, by name
    dev = sum(per.values())  # a call: one launch of each
    index_bytes = 4 * (ids.numel() + n * k + n * (grid[0] * grid[1] + 1))
    b = bound(src.numel() * src.element_size() + index_bytes + got.numel() * got.element_size(), src.numel(),
              grad.dtype)
    log(f"[{where}] K4 {tag} ({size} bytes a pixel) grad{tuple(grad.shape)} -> map{tuple(got.shape)}: "
        f"max|d| {err:.3e} (<= {tol:g}), two calls bitwise equal {same}; whole call {ms:.4f} ms, device "
        f"{dev:.4f} ms a call (index launch {per[names[0]]:.4f} ms, {names[1]} {per[names[1]]:.4f} ms), host "
        f"{hus:.1f} us a call (200 queued), plain {pms:.3f} ms, zero_ + index_add_ {lms:.4f} ms (index_add_ alone, "
        f"into a map that exists, {bare:.4f} ms) (medians of 20); bound {b['bound_ms']:.4f} ms ({b['bound_by']}), "
        f"{100 * b['bound_ms'] / dev:.0f} % of it by device time ({100 * b['bound_ms'] / per[names[1]]:.0f} % by the "
        f"sum's alone), {100 * b['bound_ms'] / ms:.0f} % whole call")
    del got, again, ref, acc, src, rows
    return {"max_abs_err": err, "ms": ms, "plain_ms": pms, "library_ms": lms, "device_ms": dev,
            "index_ms": per[names[0]], "host_us": hus, **b}


def phase2_narrow(gen, smi: str) -> None:
    """K3, K4 and K6 at pixels that no 16-byte vector divides: bf16 C = 196,
    130, 33 and f32 C = 130, 33 (the span instances of K3 and K4; K6 moves 16
    bytes a lane at any pixel), at the main path's shapes (K3 the query step's
    [16, 256, 256, C] with 512 windows; K4 the train step's 1228 slots onto
    [4, 256, 256, C]; K6 the sparse FPN's 512 patches of 9 x 9). K3 and K6
    bitwise equal to their plain versions (K6 also on maps 2, 4, 8 bytes past
    an alignment), K3 by the name of its span kernel; K4 within 7a's
    tolerances of its plain version and its two calls bitwise equal, its two
    launches by name (:func:`k3_record`, :func:`k4_record`, :func:`k6_case`)."""
    h = w = 256
    hc, win, n4, k4 = h // 4, 9, TRAIN_B, 1228

    def query_ids(n, k):
        ids = torch.randint(0, hc * hc, (n, k), generator=gen, device="cuda", dtype=torch.int32)
        ids[:, :8] = torch.tensor([-1, -7, 4096, 5000, 0, 63, 4032, 4095], dtype=torch.int32)
        return ids

    sids = torch.randint(0, hc * hc, (n4, k4), generator=gen, device="cuda", dtype=torch.int32)
    sids[:, 1028:] = sids[:, :200]  # GT slots repeating predicted cells
    sids[:, 1000:1028] = -1  # unfilled prediction slots
    for dtype, c in NARROW_PIXELS:
        dt = "f32" if dtype == torch.float32 else "bf16"
        feat = torch.randn(B, h, w, c, generator=gen, device="cuda").to(dtype)
        r0 = torch.randint(-win - 4, h + 4, (B, 512), generator=gen, device="cuda", dtype=torch.int32)
        c0 = torch.randint(-win - 4, w + 4, (B, 512), generator=gen, device="cuda", dtype=torch.int32)
        r0[:, -16:] = -10 * win
        k6_case("2n", f"{dt} C = {c}", feat, r0, c0, win)
        check(window_instance(c * feat.element_size(), feat.data_ptr()) == "span", f"{dt} C = {c} is not narrow")
        k3_record("2n", f"{dt} C = {c}", feat, query_ids(B, 512))
        del feat
        grad = torch.randn(n4, k4, 25, c, generator=gen, device="cuda").to(dtype)
        k4_record("2n", f"{dt} C = {c}", grad, sids, (h, w))
        del grad
        torch.cuda.empty_cache()
    log(f"[2n] on {smi}")


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
    outs, coarse = {}, []
    for dev in ("cuda", "cpu"):
        model = _model(cfg, dev)
        if dev == "cuda":  # the coarse transformer's outputs, for K2's bf16 instance below
            model.loftr_coarse.register_forward_hook(lambda _m, _i, out: coarse.append(out))
        t0 = time.perf_counter()
        with torch.no_grad():
            out = model({k: v.to(dev) for k, v in batch.items()})
        if dev == "cuda":
            torch.cuda.synchronize()
        outs[dev] = {k: v.cpu() for k, v in out.items() if torch.is_tensor(v)}
        log(f"[3] f32 forward on {dev}: {time.perf_counter() - t0:.2f} s (first call)")
        if dev == "cuda":
            gpu_batch = {k: v.to(dev) for k, v in batch.items()}
            with torch.no_grad():
                rows, busy, _ = device_rows(lambda: model(gpu_batch))
            k1_rows = [r for r in rows if _short(r[2]) in K1_NAMES]
            log(f"[3] the f32 forward's K1 (12 layer calls): device {group_ms(rows, K1_NAMES):.3f} ms of "
                f"{busy:.3f} ms, launches {launch_names(k1_rows)}")
            check_f32_instances(rows, "3")
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
    # K2's bf16 instance on this forward's coarse features: the same mutual
    # nearest neighbours as the plain bf16 version (the CPU path), thr 0
    feat0, feat1 = coarse[0]
    cm = cfg.coarse_matching
    sel = dict(temperature=cm.temperature, grid_hw=(64, 64), thr=cm.thr, border_rm=cm.border_rm,
               k=cm.max_matches, border_two_sided=cm.border_two_sided, feat_norm=cm.feat_norm_method,
               dtype=torch.bfloat16)
    before = kernels.launch_counts()["K2_rowcol_stats"]
    kern = fused_select_topk_matches(feat0, feat1, **sel)
    check(kernels.launch_counts()["K2_rowcol_stats"] == before + 1, "K2 did not launch")
    plain = fused_select_topk_matches(feat0.cpu(), feat1.cpu(), **sel)
    sets = [[set(zip(m.i_ids[f][m.mask[f]].tolist(), m.j_ids[f][m.mask[f]].tolist())) for f in range(2)]
            for m in (kern, plain)]
    conf_d = max((kern.mconf[f][kern.mask[f]].cpu().sort().values
                  - plain.mconf[f][plain.mask[f]].sort().values).abs().max().item()
                 if sets[0][f] == sets[1][f] and sets[0][f] else 0.0 for f in range(2))
    log(f"[3] K2 bf16 (tensor cores) on this forward's coarse features {tuple(feat0.shape)} x "
        f"{tuple(feat1.shape)}: matches {[len(x) for x in sets[0]]}, the plain bf16 version "
        f"{[len(x) for x in sets[1]]}, same match set {sets[0] == sets[1]}, mconf max|d| {conf_d:.3e}")
    check(sets[0] == sets[1] and all(sets[0]), "K2's bf16 instance changes the match set")


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
    for b in (16, 48):
        phase4_graph(rng, b)


def _pnp_call_ms(fn):
    """(wall ms, device ms between two events, each the median of five; the
    kernels the profiler kept of one call)."""
    walls, spans = [], []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        end.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        spans.append(start.elapsed_time(end))
    rows, _, _ = device_rows(fn, reps=5)
    return float(np.median(walls)), float(np.median(spans)), sum(r[1] for r in rows) // 5


def phase4_graph(rng, b: int) -> None:
    """The query step's PnP (512 slots, 512 hypotheses, its options) through
    PnPGraphs: the first call eager, the second captured, all four bitwise
    the eager solver's; then one eager call against one replay."""
    dev = "cuda"
    K, pts, Ts = _scene(rng, b, 7000)
    gen = torch.Generator(device=dev)
    gen.manual_seed(b)
    graphs = PnPGraphs()
    for i in range(4):
        p3, p2 = [], []
        for T in Ts:
            idx = rng.choice(7000, 512, replace=False)
            pc = pts[idx] @ T[:3, :3].T + T[:3, 3]
            uv = pc[:, :2] / pc[:, 2:3] @ K[:2, :2].T + K[:2, 2] + rng.normal(0, 0.5, (512, 2))
            bad = rng.random(512) < 0.2
            uv[bad] = rng.uniform(0, 512, (int(bad.sum()), 2))
            p3.append(pts[idx])
            p2.append(uv)
        t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
        valid = torch.from_numpy(rng.random((b, 512)) > 0.1).to(dev)
        args = (t(p3), t(p2), t(np.tile(K, (b, 1, 1))), valid,
                *sample_hypotheses(valid, gen, num_hypotheses=512, prescore_subset=128))
        got, want = graphs(*args), ransac_pnp_from_samples(*args)
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"PnP's graph {'replay' if i else 'first call'} at B {b} differs from the eager solver")
    check(next(iter(graphs._graphs.values())) is not None, f"PnP's graph did not capture at B {b}")
    ok = float(want.ok.float().mean())
    eager = _pnp_call_ms(lambda: ransac_pnp_from_samples(*args))
    replay = _pnp_call_ms(lambda: graphs(*args))
    log(f"[4g] PnPGraphs at B {b} (N 512, H 512): 4 calls (eager, capture, 2 replays) bitwise the eager solver's, "
        f"ok {ok:.3f}; one call, eager / replay: wall {eager[0]:.3f} / {replay[0]:.3f} ms, device span "
        f"{eager[1]:.3f} / {replay[1]:.3f} ms, {eager[2]} / {replay[2]} kernels")


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
    expected = {"K1_encoder_layer": 12 * steps, "K2_rowcol_stats": steps, "K3_window_gather": steps,
                "K4_window_scatter": 0, "K5_coarse_loss": 0, "K5_coarse_loss_bwd": 0,
                "K6_patch_gather": 0, "K7_short_encoder": 0}
    log(f"[5] launches in the main-path run: {counts} (expected {expected})")
    check(counts == expected, "a kernel of the main path was not launched as the step implies")
    check(res.poses.shape == (n_frames, 4, 4), f"poses {res.poses.shape}")
    check(bool(np.isfinite(res.poses[res.ok]).all()), "non-finite pose where ok")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[5] bf16 bench config, {n_frames} frames of 512^2, frame_batch 16, 7000 points: "
        f"{n_frames / wall:.2f} poses/s ({wall:.3f} s wall, synchronised), peak memory "
        f"{peak:.2f} GiB, ok {int(res.ok.sum())}/{n_frames}, median matches "
        f"{int(np.median(res.num_matches))} on {smi}")
    return counts, model, frames, anno, res


def phase5m(model, frames, anno, res5, smi: str) -> dict:
    """Phase 5's run through run_inference's mesh path: world 1 over NCCL (one
    rank a GPU; world 1 needs one), held bitwise to phase 5's result (same
    device, same draws), with its launches, poses/s, peak memory and the wall
    of the one gather an object. Leaves the process group before any later
    phase makes its own."""
    m = make_mesh("cuda", 0, 1)
    gather, walls = pipeline._gather_frames, []

    def timed_gather(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gather(*args)  # ends in a copy to the host
        walls.append(time.perf_counter() - t0)
        return out

    pipeline._gather_frames = timed_gather
    run_inference(model, frames[:16], anno, shape3d=7000, frame_batch=16, mesh=m)  # warm-up: NCCL's first call
    first_gather = walls[-1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_inference(model, frames, anno, shape3d=7000, frame_batch=16, mesh=m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for _ in range(3):  # later objects' gathers: one batch each
        run_inference(model, frames[:16], anno, shape3d=7000, frame_batch=16, mesh=m)
    pipeline._gather_frames = gather
    release_mesh()
    steps = len(frames) // 16
    expected = {"K1_encoder_layer": 12 * steps, "K2_rowcol_stats": steps, "K3_window_gather": steps,
                "K4_window_scatter": 0, "K5_coarse_loss": 0, "K5_coarse_loss_bwd": 0,
                "K6_patch_gather": 0, "K7_short_encoder": 0}
    log(f"[5m] launches in the mesh run: {counts} (expected {expected})")
    check(counts == expected, "a kernel of the mesh path was not launched as the step implies")
    same = {k: bool(np.array_equal(getattr(res, k), getattr(res5, k)))
            for k in ("poses", "num_inliers", "ok", "num_matches", "R_errs", "t_errs")}
    check(all(getattr(res, k).dtype == getattr(res5, k).dtype for k in same), "the mesh run's dtypes differ")
    log(f"[5m] run_inference(mesh=make_mesh('cuda', 0, 1)), NCCL world 1, {len(frames)} frames, frame_batch 16: "
        f"bitwise equal to phase 5 {same}, metrics equal {res.metrics == res5.metrics}")
    check(all(same.values()) and res.metrics == res5.metrics, "the mesh run differs from phase 5's")
    log(f"[5m] {len(frames) / wall:.2f} poses/s ({wall:.3f} s wall, synchronised), peak memory {peak:.2f} GiB, "
        f"the one gather {walls[-4] * 1e3:.3f} ms ({len(frames)} frames; the warm-up's, NCCL's first call, "
        f"{first_gather * 1e3:.3f} ms; three later objects' of 16 frames "
        f"{', '.join(f'{w * 1e3:.3f}' for w in walls[-3:])} ms) on {smi}")
    return counts


# torch.profiler's sessions in this run: how many, how many had to be profiled
# again, and each session's least kernel start less its launch's (launch_offset_ms)
PROFILER = {"sessions": 0, "again": 0, "offsets": []}  # offsets: (s into the run, ms)
STARTED = time.perf_counter()
# margins (s) before and after the profiled calls, one an attempt
PROFILER_MARGINS = (0.05, 0.25, 1.0, 3.0, 6.0)


def launch_offset_ms(prof):
    """The least (kernel start - its launch's start), ms, over the session's
    kernels, each paired with the runtime call that launched it by their
    correlation id: a few microseconds where the profiler maps the device's
    clock onto the host's truly; None where no pair was kept."""
    events = prof.profiler.kineto_results.events()
    launches = {e.correlation_id(): e.start_ns() for e in events
                if e.device_type().name == "CPU" and e.name().startswith("cu")}
    gaps = [e.start_ns() - launches[e.correlation_id()] for e in events
            if e.device_type().name == "CUDA" and e.correlation_id() in launches]
    return min(gaps) / 1e6 if gaps else None


def device_rows(fn, reps: int = 1):
    """(device-time rows (ms, count, kernel name), total device ms, wall ms of
    the profiled calls) of `reps` calls of fn under torch.profiler. The
    profiler keeps only the device events it maps inside its session, and its
    map of the device's clock onto the host's has been off by up to tens of
    milliseconds either way in this process (``launch_offset_ms``; the run's
    last [profiler] line): a short session then loses the launches at its
    start or its end, or all of them. So the calls sit between idle margins,
    and a session that saw no device time is profiled again with wider ones
    (``PROFILER_MARGINS``)."""
    for margin in PROFILER_MARGINS:
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            time.sleep(margin)
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
            time.sleep(margin)
        PROFILER["sessions"] += 1
        rows = sorted(((e.device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                       if e.device_type.name == "CUDA" and e.device_time_total > 0), reverse=True)
        busy = sum(r[0] for r in rows)
        if busy > 0:
            offset = launch_offset_ms(prof)
            if offset is not None:
                PROFILER["offsets"].append((time.perf_counter() - STARTED, offset))
            break
        PROFILER["again"] += 1
        log(f"[profiler] a session with {margin} s margins, {time.perf_counter() - STARTED:.0f} s into the "
            f"run, saw no device time; profiling it again")
    check(busy > 0, "the profiler saw no device time")
    return rows, busy, wall


def group_ms(rows, names) -> float:
    pat = re.compile(r"\b(" + "|".join(names) + r")\b")
    return sum(r[0] for r in rows if pat.search(r[2]))


def _short(key: str) -> str:
    """A kernel's name without namespaces, template and function arguments."""
    m = re.search(r"(\w+)(?:<[^(]*>)?\(", key)
    return m.group(1) if m else key[:40]


def only_launches(rows, names) -> bool:
    """Whether the profiled calls launched exactly the kernels in `names`, each at least once."""
    return {_short(r[2]) for r in rows} == set(names)


def launch_names(rows) -> str:
    """'kernel ms (mean of its launches) xcount, ...' of device_rows' rows."""
    return ", ".join(f"{_short(key)} {ms / count:.4f} ms x{count}" for ms, count, key in rows)


K1_TC_NAMES = ("kv_partial_tc_kernel", "kv_reduce_tc_kernel", "apply_tc_kernel")  # bf16, tensor cores
K1_TCW_NAMES = ("tcw_pack_kernel", "tcw_gemm_kernel", "tcw_kv_reduce_kernel", "tcw_ln_image_kernel",
                "tcw_ln_residual_kernel")  # bf16 at every other width
K1_TCW32_NAMES = ("tcw32_pack_kernel", "tcw32_gemm_kernel", "tcw32_kv_reduce_kernel", "tcw32_ln_image_kernel",
                  "tcw32_ln_residual_kernel")  # f32 in split TF32 at every width
K1_NAMES = K1_TC_NAMES + K1_TCW_NAMES + K1_TCW32_NAMES
# K2's bf16 instance (tensor cores), its operand pack first; its f32 instance in
# split TF32 (tensor cores), its pack first; above 576 channels K2_WIDE_NAMES
K2_TC_NAMES = ("pack_operand_kernel", "lse_tc_kernel", "col_lse_reduce", "argmax_tc_kernel", "col_argmax_reduce")
K2_TF32_NAMES = ("pack_tf32_operand_kernel", "lse_tf32x3_kernel", "col_lse_reduce", "argmax_tf32x3_kernel",
                 "col_argmax_reduce")
K2_NAMES = tuple(dict.fromkeys(K2_TC_NAMES + K2_TF32_NAMES + K2_WIDE_NAMES["bf16"] + K2_WIDE_NAMES["f32"]))
# K1's bf16 kernels, which no f32 path may launch (K5 rounds its operands to
# bf16 in every path, so K2's bf16 LSE pass runs in f32 training)
K1_BF16_NAMES = K1_TC_NAMES + K1_TCW_NAMES


def check_f32_instances(rows, where: str, k1: bool = True, k2: bool = True, wide: bool = False) -> None:
    """A profiled f32 path ran the split-TF32 instances of K1 (its chain) and
    K2 (at C = 256, or K2's wide one above 576 channels) where it runs them,
    none of K1's bf16 kernels and no ``*_tf32x3_kernel`` but K2's."""
    names = {_short(r[2]) for r in rows}
    k2_names = ({"lse_wide_tf32x3_kernel", "argmax_wide_tf32x3_kernel"} if wide
                else {"lse_tf32x3_kernel", "argmax_tf32x3_kernel"})
    want = (set(K1_TCW32_NAMES) if k1 else set()) | (k2_names if k2 else set())
    k2_all = set(K2_NAMES)
    stray = {n for n in names if n.endswith("_tf32x3_kernel") and n not in k2_all}
    log(f"[{where}] f32 instances by name: {sorted(want & names)} ran; bf16 kernels of K1: "
        f"{sorted(set(K1_BF16_NAMES) & names) or 'none'}; other *_tf32x3_kernel: {sorted(stray) or 'none'}")
    check(want <= names and not set(K1_BF16_NAMES) & names and not stray,
          f"[{where}] the f32 path did not run K1/K2's split-TF32 instances alone: {sorted(names)}")
K3_NAMES = ("window_gather_kernel", "window_span_kernel")


def _step_batch(frames, anno, dev="cuda"):
    """(step batch, GT poses, the forward's batch) of the first B frames: uint8
    frames and the unbatched cloud, as the step takes them, and what the step
    hands the model."""
    chunk = frames[:B]
    batch = {
        "query_image": torch.from_numpy(np.stack([f["image"][..., None] for f in chunk])).to(dev),
        "intrinsics": torch.from_numpy(np.stack([f["K"] for f in chunk])).to(dev),
        **{k: torch.from_numpy(v).to(dev) for k, v in anno.items()},
    }
    gt = torch.from_numpy(np.stack([f["pose_gt"] for f in chunk])).to(dev)
    fwd = {**batch, "query_image": batch["query_image"].float() / 255.0,
           **{k: batch[k][None].expand(B, *batch[k].shape) for k in anno}}
    return batch, gt, fwd


def _step_wall(step, batch, gt) -> float:
    """Median wall ms of 5 synchronised steps after 3 warm-ups."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    walls = []
    for i in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch, gen, gt)
        torch.cuda.synchronize()
        if i >= 3:
            walls.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(walls))


def phase6(model, frames, anno, smi: str) -> None:
    """Where the time goes in one bf16 step of phase 5 (the first 16 frames)."""
    dev = "cuda"
    batch, gt, fwd_batch = _step_batch(frames, anno)
    step = make_query_step(model)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    wall = _step_wall(step, batch, gt)
    # the model forward alone, on the inputs the step hands it
    with torch.no_grad():
        fwd = time_ms(lambda: model(fwd_batch), reps=5, warmup=1)
    rows, busy, _ = device_rows(lambda: step(batch, gen, gt))
    group = lambda names: group_ms(rows, names)  # noqa: E731

    k1, k2, k3 = group(K1_NAMES), group(K2_NAMES), group(K3_NAMES)
    log(f"[6] bf16 step, {B} frames of 512^2, 7000 points, 512 slots: wall {wall:.2f} ms "
        f"(median of 5, synchronised), model forward {fwd:.2f} ms (CUDA events, median of 5), "
        f"device time in one profiled step {busy:.2f} ms, idle share "
        f"{100 * (1 - busy / wall):.1f} % of the step wall, on {smi}")
    log(f"[6] device time: K1 {k1:.2f} ms, K2 {k2:.2f} ms, K3 {k3:.3f} ms, "
        f"everything else {busy - k1 - k2 - k3:.2f} ms")
    k2_rows = [r for r in rows if _short(r[2]) in K2_NAMES]
    log(f"[6] K2's launches in the step: {launch_names(k2_rows)} (the operand pack included)")
    copies = [r for r in rows if "copy_kernel" in r[2] or "Memcpy" in r[2]]
    log(f"[6] casts and copies in the step (every launch whose name holds copy_kernel or Memcpy): "
        f"{sum(r[0] for r in copies):.2f} ms in {sum(r[1] for r in copies)} launches")
    for ms, count, key in rows[:25]:
        log(f"[6]   {ms:9.3f} ms  x{count:<5d} {key[:100]}")
    # one coarse layer through the model's own call: its weights were packed
    # when the layer first ran, so the call launches K1's three kernels and
    # no transpose or cast of a weight
    layer = model.loftr_coarse.layers[0]
    x = torch.randn(B, 7000, 256, generator=gen, device=dev)
    with torch.no_grad():
        layer(x, x, fused=True)
        lrows, lbusy, _ = device_rows(lambda: layer(x, x, fused=True), reps=5)
    log(f"[6] five coarse layer calls (self, [{B}, 7000, 256]) launch {launch_names(lrows)} "
        f"({lbusy / 5:.3f} ms a call)")
    check(only_launches(lrows, K1_TC_NAMES), "a coarse layer call launches something besides K1's kernels")
    # the eager fine transformer on streams of this step's fine shapes (16 x 512
    # windows): its share of the step, what routing it to K7 could change
    f0 = torch.randn(B * 512, 1, 128, generator=gen, device=dev).to(torch.bfloat16)
    f1 = torch.randn(B * 512, 25, 128, generator=gen, device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        model.loftr_fine(f0, f1)
        frows, fbusy, _ = device_rows(lambda: model.loftr_fine(f0, f1), reps=3)
    log(f"[6] the eager fine transformer at f0[{B * 512}, 1, 128] f1[{B * 512}, 25, 128] (this step's fine "
        f"stage): {fbusy / 3:.3f} ms of device time a call in {sum(r[1] for r in frows) // 3} launches, "
        f"{100 * fbusy / 3 / busy:.1f} % of the step's device time")


# ----------------------------------------------------------------- phase 7


K4_PREVIOUS_MS = 0.393  # f32, eight PyTorch launches before the one kernel (NVIDIA H100 80GB HBM3, 700.00 W)
K5_PREVIOUS_MS = 31.504  # forward + backward on the CUDA-core tile (NVIDIA H100 80GB HBM3, 700.00 W)


def phase7a(gen) -> dict:
    """K4 at the train shapes: map [4,256,256,128], 1028 predicted + 200 GT slots."""
    n, hc, k = TRAIN_B, TRAIN_IMG // 8, 1228
    ids = torch.randint(0, hc * hc, (n, k), generator=gen, device="cuda", dtype=torch.int32)
    ids[:, 1028:] = ids[:, :200]  # GT slots repeating predicted cells
    ids[:, 1000:1028] = -1  # unfilled prediction slots
    # the index launch against the plain preparation (a stable library sort and searchsorted)
    order, cell_start = scatter_index(ids, hc * hc)
    order_ref, cell_start_ref = scatter_index_plain(ids, hc * hc)
    torch.cuda.synchronize()
    exact = torch.equal(order, order_ref) and torch.equal(cell_start, cell_start_ref)
    log(f"[7a] K4 index launch ids{tuple(ids.shape)}, {hc * hc} cells: order and cell_start equal the "
        f"plain preparation exactly {exact}")
    check(exact, "K4's index kernel disagrees with the plain preparation")
    rec = {}
    for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        grad = torch.randn(n, k, 25, 128, generator=gen, device="cuda").to(dtype)
        rec[dt] = k4_record("7a", f"train {dt}", grad, ids, (4 * hc, 4 * hc))
        if dt == "f32":
            log(f"[7a] K4 f32 whole call {rec[dt]['ms']:.4f} ms ({K4_PREVIOUS_MS} ms with the library sort in the "
                f"wrapper)")
        del grad
    keys = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    return {key: rec["f32"][key] for key in keys}  # the train config is f32


def phase7b(gen) -> dict:
    """K5 at the train shapes against its plain version (dense, autograd)."""
    c = 256
    f0 = (torch.randn(TRAIN_B, TRAIN_P, c, generator=gen, device="cuda") / 16).to(torch.bfloat16)
    f1 = (torch.randn(TRAIN_B, 4096, c, generator=gen, device="cuda") / 16).to(torch.bfloat16)
    gt = torch.randint(0, 4096, (TRAIN_B, TRAIN_P), generator=gen, device="cuda", dtype=torch.int32)
    gt = torch.where(torch.rand(TRAIN_B, TRAIN_P, generator=gen, device="cuda") < 0.5, gt, -1)
    inv_temp = 1.0 / (0.08 + 1e-4)
    n_pos = int((gt >= 0).sum())
    coefs = (1.0 / n_pos, 1.0 / (TRAIN_B * TRAIN_P * 4096 - n_pos))  # the loss's count normalisation

    def run(fn, backward=True):
        a0, a1 = f0.clone().requires_grad_(backward), f1.clone().requires_grad_(backward)
        pos, neg, mx = fn(a0, a1, gt, inv_temp, 0.5, 2.0)
        loss = coefs[0] * pos + coefs[1] * neg
        if backward:
            loss.backward()
            return loss.detach(), mx, a0.grad.float(), a1.grad.float()
        return loss.detach(), mx

    got, again, ref = run(coarse_focal_sums), run(coarse_focal_sums), run(coarse_focal_sums_plain)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    loss_rel = abs(got[0].item() - ref[0].item()) / abs(ref[0].item())
    mx_rel = abs(got[1].item() - ref[1].item()) / abs(ref[1].item())
    worst, ok = 0.0, loss_rel <= 2e-4 and mx_rel <= 2e-4 and same
    for name, g, r in (("df0", got[2], ref[2]), ("df1", got[3], ref[3])):
        scale = r.abs().max().item()
        err = (g - r).abs().max().item()
        cos = torch.nn.functional.cosine_similarity(g.flatten(), r.flatten(), dim=0).item()
        log(f"[7b] K5 {name}: max|d| {err:.3e} = {err / scale:.2e} of max|grad| (< 2e-2), cosine {cos:.6f} (> 0.999)")
        ok = ok and err < 2e-2 * scale and cos > 0.999
        worst = max(worst, err)
    log(f"[7b] K5 f0{tuple(f0.shape)} f1{tuple(f1.shape)}: loss {got[0].item():.6f} vs {ref[0].item():.6f} "
        f"(rel {loss_rel:.2e} <= 2e-4), max_conf rel {mx_rel:.2e} (<= 2e-4), two launches bitwise equal {same}")
    check(ok, "K5 disagrees with its plain version")
    del got, again, ref
    torch.cuda.empty_cache()
    fwd = time_ms(lambda: run(coarse_focal_sums, backward=False), reps=10)
    pfwd = time_ms(lambda: run(coarse_focal_sums_plain, backward=False), reps=5)
    both = time_ms(lambda: run(coarse_focal_sums), reps=10)
    pboth = time_ms(lambda: run(coarse_focal_sums_plain), reps=5)
    n_bytes = 2 * (f0.numel() + f1.numel()) * 2 + gt.numel() * 4  # bf16 features in, their gradients out, GT
    b = bound(n_bytes, 3 * 2 * TRAIN_B * TRAIN_P * 4096 * c, torch.bfloat16)  # similarity, df0, df1 products
    log(f"[7b] K5 forward: kernel {fwd:.3f} ms, plain {pfwd:.3f} ms; forward + backward: kernel "
        f"{both:.3f} ms ({K5_PREVIOUS_MS} ms on the CUDA-core tile), plain {pboth:.3f} ms (medians of "
        f"10 / 5); forward + backward bound {b['bound_ms']:.4f} ms ({b['bound_by']}); no single PyTorch "
        f"call computes the focal loss")
    rows, busy, _ = device_rows(lambda: run(coarse_focal_sums), reps=5)
    k5_rows = [r for r in rows if _short(r[2]) in K5_NAMES + K5_OLD_NAMES]
    log(f"[7b] K5 forward + backward, device time by launch: {launch_names(k5_rows)} "
        f"({sum(r[0] for r in k5_rows) / 5:.3f} ms a call; besides them the autograd wrapper's "
        f"PyTorch launches: {launch_names([r for r in rows if r not in k5_rows])})")
    check(only_launches(k5_rows, K5_NAMES), f"K5 does not launch exactly its kernels {K5_NAMES}")
    check(both < pboth, f"K5 ({both:.3f} ms) is not faster than its plain version ({pboth:.3f} ms)")
    del f0, f1, gt
    torch.cuda.empty_cache()
    k5_df_rounding(gen)
    return {"max_abs_err": worst, "ms": both, "plain_ms": pboth, **b, "library_ms": None}


def k5_df_rounding(gen) -> None:
    """Both K5 instances round each finished feature gradient to bf16 before
    the operands' scale (the TPU kernel's df.astype(bf16), then the chain
    rule in f32): on f32 features through fused_coarse_focal_loss at a
    power-of-two scale (1/16 at C = 256, 1/32 at C = 1024, 1 without the
    norm), every element of df / scale is a bf16 value."""
    for c, n, p, l in ((256, TRAIN_B, TRAIN_P, 4096), (1024, 2, 1000, 700)):
        for feat_norm in ("sqrt_feat_dim", "none"):
            scale = c ** -0.5 if feat_norm == "sqrt_feat_dim" else 1.0
            mag = 1.0 if feat_norm == "sqrt_feat_dim" else c ** -0.5  # the same similarities either way
            f0 = (torch.randn(n, p, c, generator=gen, device="cuda") * mag).requires_grad_()
            f1 = (torch.randn(n, l, c, generator=gen, device="cuda") * mag).requires_grad_()
            gt = torch.randint(0, l, (n, p), generator=gen, device="cuda", dtype=torch.int32)
            gt = torch.where(torch.rand(n, p, generator=gen, device="cuda") < 0.5, gt, -1)
            loss, _ = fused_coarse_focal_loss(f0, f1, gt, 0.08, feat_norm=feat_norm)
            loss.backward()
            torch.cuda.synchronize()
            off = [int((g / scale != (g / scale).to(torch.bfloat16).float()).sum()) for g in (f0.grad, f1.grad)]
            nonzero = [int((g != 0).sum()) for g in (f0.grad, f1.grad)]
            log(f"[7b] K5 {k5_instance(c)[0]} instance, C = {c}, feat_norm {feat_norm!r} (scale {scale:g}), "
                f"f0[{n}, {p}, {c}] f1[{n}, {l}, {c}]: elements of df0 / scale, df1 / scale that are not bf16 "
                f"values {off} (0), nonzero {nonzero}")
            check(off == [0, 0] and min(nonzero) > 0, f"K5 {k5_instance(c)[0]} at C = {c} does not round df to bf16")
            del f0, f1, gt, loss


# K5 above 576 channels: K2's wide pack and LSE pass, then the loss and g sums on its
# channel-streaming tile and the feature gradients in thread-block clusters
K5_WIDE_NAMES = ("pack_wide_bf16_kernel", "lse_wide_bf16_kernel", "col_lse_reduce", "loss_wide_kernel",
                 "gsum_wide_kernel", "colg_reduce", "dfeat_wide_kernel")
K5_WIDE_PREVIOUS_MS = {640: 76.620, 1024: 116.082}  # the CUDA-core instance (NVIDIA H100 80GB HBM3, 700.00 W)


def k5_names(c: int):
    return K5_NAMES if k5_instance(c)[0] == "tc" else K5_WIDE_NAMES


def phase7f(gen, smi: str) -> None:
    """K5 at the coarse widths above 256 that K1 takes, at the train shapes
    [4, 7000] x [4, 4096]: C = 384 and 512 on the resident tile (feature
    gradients in 256-channel chunks), 640, 1024, 2048 and 4096 on the wide
    instance (feature gradients in clusters of 256-channel slices); forward
    and backward against the plain version with 7b's tolerances, two launches
    bitwise equal, whole call and device time by launch beside the bound
    (three products at the bf16 peak, as 7b's) and the cluster size."""
    l = 4096
    inv_temp = 1.0 / (0.08 + 1e-4)
    for c in (384, 512, 640, 1024, 2048, 4096):
        instance, blocks = k5_instance(c)
        names = k5_names(c)
        f0 = (torch.randn(TRAIN_B, TRAIN_P, c, generator=gen, device="cuda") / c ** 0.5).to(torch.bfloat16)
        f1 = (torch.randn(TRAIN_B, l, c, generator=gen, device="cuda") / c ** 0.5).to(torch.bfloat16)
        gt = torch.randint(0, l, (TRAIN_B, TRAIN_P), generator=gen, device="cuda", dtype=torch.int32)
        gt = torch.where(torch.rand(TRAIN_B, TRAIN_P, generator=gen, device="cuda") < 0.5, gt, -1)
        n_pos = int((gt >= 0).sum())
        coefs = (1.0 / n_pos, 1.0 / (TRAIN_B * TRAIN_P * l - n_pos))

        def run(fn, backward=True):
            a0, a1 = f0.clone().requires_grad_(backward), f1.clone().requires_grad_(backward)
            pos, neg, mx = fn(a0, a1, gt, inv_temp, 0.5, 2.0)
            loss = coefs[0] * pos + coefs[1] * neg
            if backward:
                loss.backward()
                return loss.detach(), mx, a0.grad.float(), a1.grad.float()
            return loss.detach(), mx

        got, again, ref = run(coarse_focal_sums), run(coarse_focal_sums), run(coarse_focal_sums_plain)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        loss_rel = abs(got[0].item() - ref[0].item()) / abs(ref[0].item())
        mx_rel = abs(got[1].item() - ref[1].item()) / abs(ref[1].item())
        ok, grads = loss_rel <= 2e-4 and mx_rel <= 2e-4 and same, []
        for name, g, r in (("df0", got[2], ref[2]), ("df1", got[3], ref[3])):
            scale = r.abs().max().item()
            err = (g - r).abs().max().item()
            cos = torch.nn.functional.cosine_similarity(g.flatten(), r.flatten(), dim=0).item()
            grads.append(f"{name} max|d| {err / scale:.2e} of max|grad| (< 2e-2), cosine {cos:.6f} (> 0.999)")
            ok = ok and err < 2e-2 * scale and cos > 0.999
        blocks_of = "chunk(s)" if instance == "tc" else "block(s) a cluster"
        log(f"[7f] K5 C = {c} ({instance}, {blocks} {blocks_of}) f0{tuple(f0.shape)} f1{tuple(f1.shape)}: loss "
            f"rel {loss_rel:.2e} (<= 2e-4), max_conf rel {mx_rel:.2e} (<= 2e-4), {'; '.join(grads)}; two "
            f"launches bitwise equal {same}")
        check(ok, f"K5 at C = {c} disagrees with its plain version")
        del got, again, ref
        torch.cuda.empty_cache()
        both = time_ms(lambda: run(coarse_focal_sums), reps=5, warmup=1)
        pboth = time_ms(lambda: run(coarse_focal_sums_plain), reps=3, warmup=1)
        rows, busy, _ = device_rows(lambda: run(coarse_focal_sums), reps=2)
        k5_rows = [r for r in rows if _short(r[2]) in names]
        check(only_launches(k5_rows, names), f"K5 at C = {c} does not launch exactly {names}: {launch_names(rows)}")
        n_bytes = 2 * (f0.numel() + f1.numel()) * 2 + gt.numel() * 4
        b = bound(n_bytes, 3 * 2 * TRAIN_B * TRAIN_P * l * c, torch.bfloat16)
        device = sum(r[0] for r in k5_rows) / 2
        before = f" ({K5_WIDE_PREVIOUS_MS[c]} ms on the CUDA cores)" if c in K5_WIDE_PREVIOUS_MS else ""
        log(f"[7f] K5 C = {c}: forward + backward kernel {both:.3f} ms whole call{before}, plain {pboth:.3f} ms "
            f"(medians of 5 / 3); device time by launch: {launch_names(k5_rows)} ({device:.3f} ms a call, "
            f"{100 * b['bound_ms'] / device:.1f} % of the bound); bound {b['bound_ms']:.4f} ms ({b['bound_by']}); "
            f"{blocks} {blocks_of}; no single PyTorch call computes the focal loss; on {smi}")
        del f0, f1, gt
        torch.cuda.empty_cache()


def _train_batch(rng, n, img, n_pts, dev, coarse_dim=256):
    """Textured frames of a synthetic scene; GT cells and fine locations from
    projecting its points with the GT poses."""
    K, pts, Ts = _scene(rng, n, n_pts, img=float(img))
    w_c = img // 8
    gt_cell = np.full((n, n_pts), -1, np.int32)
    gt_fine = np.full((n, n_pts, 2), -50.0, np.float32)
    for i, T in enumerate(Ts):
        pc = pts @ T[:3, :3].T + T[:3, 3]
        uv = pc[:, :2] / pc[:, 2:3] @ K[:2, :2].T + K[:2, 2]
        cell = np.round(uv / 8).astype(np.int64)
        inb = (cell >= 0).all(1) & (cell < w_c).all(1) & (pc[:, 2] > 0)
        gt_cell[i, inb] = cell[inb, 1] * w_c + cell[inb, 0]
        gt_fine[i, inb] = uv[inb]
    batch = {
        "query_image": _textured_images(rng, n, img)[..., None],
        "keypoints3d": np.broadcast_to(pts, (n, n_pts, 3)).astype(np.float32),
        "descriptors3d": rng.standard_normal((n, n_pts, 128)).astype(np.float32),
        "descriptors3d_coarse": rng.standard_normal((n, n_pts, coarse_dim)).astype(np.float32),
        "gt_cell": gt_cell,
        "gt_fine_xy": gt_fine,
    }
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in batch.items()}


def _train_model(cfg, dev):
    model = OnePosePlusModel(cfg)
    model.load_state_dict(random_state_dict(model, seed=0))
    return model.to(dev).train()


def wide_train_config(d_model: int) -> OnePosePlusConfig:
    """The train config with a coarse stage of ``d_model`` channels (the
    backbone's coarse level, the keypoint encoding and the coarse transformer)."""
    base = OnePosePlusConfig()
    return dataclasses.replace(
        base, backbone=dataclasses.replace(base.backbone, block_dims=(*base.backbone.block_dims[:2], d_model)),
        keypoints_encoding=KeypointEncodingConfig(descriptor_dim=d_model),
        coarse=dataclasses.replace(base.coarse, d_model=d_model))


def phase7c(d_model: int = 256) -> None:
    """One f32 micro-batch, fused route: GPU (kernels) against CPU (plain
    versions), at the train config's coarse width or a wider one."""
    rng = np.random.default_rng(7)
    cfg = wide_train_config(d_model)
    batch = _train_batch(rng, 2, 128, 500, "cpu", coarse_dim=d_model)
    rows = sample_gt_rows(batch["gt_cell"], cfg.coarse_matching.train_pad_num_gt_min,
                          torch.Generator().manual_seed(0))  # the same GT slots on both devices
    res = {}
    for dev in ("cuda", "cpu"):
        model = _train_model(cfg, dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        before = kernels.launch_counts()
        out = model(b, gt_pad_rows=rows.to(dev))
        loss, sc = compute_losses(out, b, LossConfig(), cfg.fine.window_size)
        loss.backward()
        if dev == "cuda":  # the fused route: K5 once forward, once backward
            after = kernels.launch_counts()
            k5 = (after["K5_coarse_loss"] - before["K5_coarse_loss"],
                  after["K5_coarse_loss_bwd"] - before["K5_coarse_loss_bwd"])
            check(k5 == (1, 1), f"the fused micro-batch at d_model {d_model} launched K5 {k5}")
        res[dev] = ({k: float(v.detach()) for k, v in sc.items()},
                    {n: p.grad.cpu() for n, p in model.named_parameters() if p.grad is not None},
                    out["match_mask"].cpu(), out["i_ids"].cpu(), out["j_ids"].cpu())
        if dev == "cuda":  # the fused route's selection: K2's split-TF32 instance (no K1 in training)
            with torch.no_grad():
                prof_rows, _, _ = device_rows(lambda: model(b, gt_pad_rows=rows.to(dev)), reps=2)
            check_f32_instances(prof_rows, "7c", k1=False, wide=k2_instance(d_model, torch.float32) == "wide_tf32")

            def step():
                o = model(b, gt_pad_rows=rows.to(dev))
                compute_losses(o, b, LossConfig(), cfg.fine.window_size)[0].backward()

            names = set(k5_names(d_model)) - {"col_lse_reduce"}  # col_lse_reduce serves K2 too
            others = set(K5_NAMES + K5_WIDE_NAMES) - names - {"col_lse_reduce"}
            ran = {_short(r[2]) for r in device_rows(step, reps=2)[0]}
            log(f"[7c] K5 at coarse d_model {d_model}, {k5_instance(d_model)[0]} instance, kernels by name: "
                f"{sorted(names & ran)} ran; the other instance's: {sorted(others & ran) or 'none'}")
            check(names <= ran and not others & ran, f"K5 at d_model {d_model} did not launch its instance's "
                  f"kernels {sorted(names)}: {sorted(ran)}")
    (sg, gg, mg, ig, jg), (sc_, gc, mc, ic, jc) = res["cuda"], res["cpu"]
    same_slots = torch.equal(mg, mc) and torch.equal(ig[mg], ic[mc]) and torch.equal(jg[mg], jc[mc])
    rel = {k: abs(sg[k] - sc_[k]) / max(abs(sc_[k]), 1e-12) for k in sc_}
    log(f"[7c] f32 micro-batch, coarse d_model {d_model} (K5 {k5_instance(d_model)[0]}, K2 "
        f"{k2_instance(d_model, torch.float32)}), 2 frames of 128^2, "
        f"500 points, fused route (K5 launched once forward, once backward): GPU {sg} vs CPU {sc_}; "
        f"same match slots {same_slots} ({int(mg.sum())} valid)")
    worst_norm, worst_max, bad = 0.0, 0.0, []
    for name, r in gc.items():
        g = gg[name]
        nr = r.norm().item()
        if nr == 0:
            continue
        norm_err = (g - r).norm().item() / nr
        cos = torch.nn.functional.cosine_similarity(g.flatten(), r.flatten(), dim=0).item()
        worst_norm = max(worst_norm, norm_err)
        ok = norm_err <= 2e-2 and cos >= 0.999
        if not name.startswith("backbone."):
            max_err = (g - r).abs().max().item() / r.abs().max().item()
            worst_max = max(worst_max, max_err)
            ok = ok and max_err <= 2e-2
        if not ok:
            bad.append(name)
    log(f"[7c] gradients of {len(gc)} tensors: worst relative norm error {worst_norm:.2e} (<= 2e-2, "
        f"cosine >= 0.999), worst max error outside the backbone {worst_max:.2e} of max|grad| (<= 2e-2); "
        f"loss rel {rel['loss']:.2e} (<= 2e-4)")
    check(same_slots and not bad and max(rel.values()) <= 2e-4 and set(gg) == set(gc),
          f"the GPU train step disagrees with the CPU one: {bad[:5]}")


def phase7d(smi: str):
    """The train config at full width: three optimizer updates on one batch."""
    rng = np.random.default_rng(8)
    cfg = OnePosePlusConfig()  # configs/experiment/train.yaml's model: {} (f32, fused route)
    tc = TrainConfig(grad_accum=2)
    torch.backends.cudnn.benchmark = True  # as the training CLI: fixed shapes, autotuned convs
    batch = _train_batch(rng, TRAIN_B, TRAIN_IMG, TRAIN_P, "cuda")
    model = _train_model(cfg, "cuda")
    opt, sched = make_optimizer(model, tc, tc.true_lr(TRAIN_B * tc.grad_accum), 1000)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, walls = [], []
    for _ in range(6):  # three updates of two micro-batches
        t0 = time.perf_counter()
        sc = train_step(model, opt, batch, gen, tc, sched)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        losses.append({k: float(v) for k, v in sc.items()})
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expected = {"K1_encoder_layer": 0, "K2_rowcol_stats": 6, "K3_window_gather": 6,
                "K4_window_scatter": 6, "K5_coarse_loss": 6, "K5_coarse_loss_bwd": 6,
                "K6_patch_gather": 0, "K7_short_encoder": 0}
    log(f"[7d] launches in 6 micro-batches: {counts} (expected {expected})")
    check(counts == expected, "a kernel of the training path was not launched as the steps imply")
    for i, v in enumerate(losses):
        log(f"[7d] micro-batch {i}: " + ", ".join(f"{k} {x:.5f}" for k, x in v.items()))
    total = [v["loss"] for v in losses]
    check(bool(np.isfinite(total).all()), "non-finite training loss")
    # the two micro-batches of an update share its parameters; GT padding resamples
    check(np.mean(total[4:]) < np.mean(total[:2]), f"training loss does not fall: {total}")
    step_ms = float(np.median(walls[1:]))
    log(f"[7d] f32 train config, {TRAIN_B} frames of {TRAIN_IMG}^2 per micro-batch, {TRAIN_P} points, "
        f"1228 slots, grad_accum 2: micro-batch {step_ms:.2f} ms (median of 5 after the first, synchronised), "
        f"{1e3 / step_ms:.2f} micro-batches/s, {TRAIN_B * 1e3 / step_ms:.2f} frames/s, peak memory "
        f"{peak:.2f} GiB, TF32 off, on {smi}")
    rows, busy, prof_wall = device_rows(lambda: train_step(model, opt, batch, gen, tc, sched))
    # the f32 config's selection runs K2's split-TF32 instance; K5 packs its
    # operands and runs K2's tensor-core LSE pass (col_lse_reduce serves both:
    # counted under K2)
    pick = lambda pat: sum(r[0] for r in rows if re.search(pat, r[2]))  # noqa: E731
    split = {
        "K2": group_ms(rows, K2_TF32_NAMES),
        "K3": group_ms(rows, K3_NAMES),
        "K4": group_ms(rows, K4_NAMES),
        "K5": group_ms(rows, tuple(n for n in K5_NAMES if n != "col_lse_reduce")),
        "conv backward (cuDNN dgrad/wgrad: the backbone)": pick(r"dgrad|wgrad|[Cc]onvolution[_ ]?[Bb]ackward"),
    }
    log(f"[7d] one micro-batch under the profiler: wall {prof_wall:.2f} ms, device time {busy:.2f} ms, "
        f"idle share {100 * (1 - busy / prof_wall):.1f} % of that wall")
    log("[7d] device time: " + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items())
        + f", everything else {busy - sum(split.values()):.2f} ms")
    for ms, count, key in rows[:25]:
        log(f"[7d]   {ms:9.3f} ms  x{count:<5d} {key[:100]}")
    k2_rows = [r for r in rows if _short(r[2]) in K2_TF32_NAMES]
    log(f"[7d] K2's launches in the micro-batch: {launch_names(k2_rows)}")
    check_f32_instances(rows, "7d", k1=False)
    return counts, step_ms


def _train_capture(root: str, n_frames: int) -> str:
    """A training manifest of the train config's shapes: n_frames textured
    512^2 frames of a ring scene and its 7000-point annotation (random
    descriptors, GT from the poses)."""
    import cv2

    rng = np.random.default_rng(75)
    K, pts, Ts = _scene(rng, n_frames, TRAIN_P, img=float(TRAIN_IMG))
    anno = os.path.join(root, "anno_3d_average.npz")
    save_3d_annotation(anno, pts.astype(np.float32), rng.standard_normal((TRAIN_P, 128)).astype(np.float32),
                       np.ones(TRAIN_P, np.float32))
    save_3d_annotation(os.path.join(root, "anno_3d_average_coarse.npz"), pts.astype(np.float32),
                       rng.standard_normal((TRAIN_P, 256)).astype(np.float32), np.ones(TRAIN_P, np.float32))
    os.makedirs(os.path.join(root, "color"))
    manifest = []
    for i, img in enumerate(_textured_images(rng, n_frames, TRAIN_IMG)):
        path = os.path.join(root, "color", f"{i:04d}.png")
        cv2.imwrite(path, (img * 255).astype(np.uint8))
        manifest.append({"img_file": path, "pose": Ts[i].tolist(), "K": K.tolist(), "avg_anno3d_file": anno,
                         "assign_pairs": np.stack([np.arange(TRAIN_P)] * 2).tolist()})
    path = os.path.join(root, "train.json")
    with open(path, "w") as f:
        json.dump(manifest, f)
    return path


def phase7e(tmp: str, step_ms_7d: float, smi: str) -> None:
    """The training CLI (``python -m onepose_plus_plus_tpu_torch.train``'s
    ``main``) at world 1 over NCCL through DDP, at the train config (f32, 4
    frames of 512^2 a micro-batch, 7000 points, grad_accum 2): four
    micro-batches with every callback on, batches pinned and copied on a side
    stream two ahead. The figure callback's forward must leave every buffer as
    it was; K2-K5 must launch as the steps imply."""
    manifest = _train_capture(tmp, 4 * TRAIN_B)
    argv = ["+experiment=train.yaml", f"dataset.train_anno_file={manifest}", "dataset.val_anno_file=null",
            f"dataset.img_resize={TRAIN_IMG}", f"dataset.shape3d_train={TRAIN_P}", "dataset.image_warp_adapt=false",
            "trainer.device=cuda", "trainer.n_devices=1", f"trainer.batch_size={TRAIN_B}", "trainer.epochs=1",
            "trainer.log_every_n_steps=2", "trainer.enable_plotting=true",
            "trainer.callbacks=[grad_stats,lr,checkpoint_artifacts]",
            f"ckpt_dir={os.path.join(tmp, 'ckpts')}", f"log_dir={os.path.join(tmp, 'logs')}"]
    figure_forwards, side_stream = [], []
    forward = train_callbacks.TrainMatchFigureCallback.forward
    put = train_cli.shard_batch

    def checked_forward(self):
        before = [b.clone() for b in self.model.buffers()]
        out = forward(self)
        figure_forwards.append(all(torch.equal(a, b) for a, b in zip(before, self.model.buffers())))
        return out

    def recorded_put(batch, mesh):
        out = put(batch, mesh)
        side_stream.append(out.event is not None and all(v.is_cuda for v in out.values()))
        return out

    train_callbacks.TrainMatchFigureCallback.forward = checked_forward
    train_cli.shard_batch = recorded_put
    stdout = io.StringIO()
    kernels.reset_launch_counts()
    try:
        with contextlib.redirect_stdout(stdout), warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            train_cli.main(argv)
    finally:
        train_callbacks.TrainMatchFigureCallback.forward = forward
        train_cli.shard_batch = put
    counts = kernels.launch_counts()
    out = stdout.getvalue()
    for line in out.splitlines():
        log(f"[7e] | {line}")
    for w in caught:
        if "figure" in str(w.message):
            log(f"[7e] warning: {w.message}")
    # four micro-batches and two figure forwards (steps 2 and 4; the figure's
    # forward selects matches (K2) and gathers windows (K3), computes no loss)
    expected = {"K1_encoder_layer": 0, "K2_rowcol_stats": 6, "K3_window_gather": 6, "K4_window_scatter": 4,
                "K5_coarse_loss": 4, "K5_coarse_loss_bwd": 4, "K6_patch_gather": 0, "K7_short_encoder": 0}
    log(f"[7e] launches: {counts} (expected {expected})")
    check(counts == expected, "the training CLI did not launch K2-K5 as its steps imply")
    check("ranks=1 (nccl)" in out, "the CLI did not train over an NCCL process group")
    log(f"[7e] figure forwards {len(figure_forwards)}, every buffer bitwise unchanged after each: "
        f"{all(figure_forwards)}; batches copied on a side stream: {sum(side_stream)} of {len(side_stream)}")
    check(len(figure_forwards) == 2 and all(figure_forwards), "the figure callback changed a buffer")
    check(len(side_stream) == 4 and all(side_stream), "the batches did not go through the pinned prefetch")
    losses = [float(m.group(1)) for m in re.finditer(r"step \d+ loss ([-\d.naif]+)", out)]
    per = [float(m.group(1)) for m in re.finditer(r"([\d.]+) ms/micro-batch", out)]
    check(len(losses) == 3 and bool(np.isfinite(losses).all()), f"training losses {losses}")  # steps 1, 2, 4
    art = os.path.join(tmp, "ckpts", "onepose_plus_train", "artifacts", "epoch_0")
    check(os.path.exists(os.path.join(art, "last.pt")), "no checkpoint artifact")
    log(f"[7e] wall per micro-batch in the CLI's loop (steps 3-4: loader, pinned prefetch, DDP step, "
        f"synchronised at the log line) {per[-1]:.2f} ms, against 7d's {step_ms_7d:.2f} ms (train_step on a "
        f"batch already on the card), on {smi}")


# ----------------------------------------------------------------- phase 8


def phase8a(gen) -> dict:
    """K6 at the SfM shapes: refine (K 1024) and extract (K 4096), W 9, on the
    [8, 256, 256, 128] fine maps of 8 image pairs of 512^2, through
    ``gather_windows`` with int32 centres, as the LoFTR ``refine`` mode calls
    it (one launch: K6 reads the centres and subtracts W // 2 itself)."""
    n, h, w, c, win = 8, 256, 256, 128, 9
    feat = torch.randn(n, h, w, c, generator=gen, device="cuda")
    rec = {}
    for k, tag in ((1024, "refine"), (4096, "extract")):
        r0 = torch.randint(-win - 4, h + 4, (n, k), generator=gen, device="cuda", dtype=torch.int32)
        c0 = torch.randint(-win - 4, w + 4, (n, k), generator=gen, device="cuda", dtype=torch.int32)
        r0[:, -16:] = -10 * win  # invalid slots: all-zero patches
        centres = torch.stack([r0, c0], -1) + win // 2  # int32 [n, k, 2], as models/loftr.py makes them
        for dt, f in (("f32", feat), ("bf16", feat.to(torch.bfloat16))):
            rec[(tag, dt)] = k6_case("8a", f"{tag} {dt}", f, r0, c0, win,
                                     call=lambda f=f: gather_windows(f, centres, win))
            del f
        torch.cuda.empty_cache()
    return rec[("refine", "bf16")]  # the SfM configuration refines in bf16


def _loftr(cfg: LoFTRConfig, device: str) -> LoFTRMatcher:
    model = LoFTRMatcher(cfg)
    model.load_state_dict(random_state_dict(model, seed=0))
    return model.eval().to(device)


def _pair_sets(out, b):
    m = out["match_mask"][b]
    return {(int(i), int(j)): s for s, i, j in zip(torch.nonzero(m)[:, 0].tolist(),
                                                    out["i_ids"][b][m].tolist(), out["j_ids"][b][m].tolist())}


def phase8b() -> None:
    """The LoFTR pair matcher in f32, full width: GPU (kernels) against CPU
    (plain versions) on one 512^2 pair shifted by (32, 16) px."""
    no_tf32()
    rng = np.random.default_rng(81)
    img0 = _textured_images(rng, 1)[..., None]
    img1 = np.ascontiguousarray(np.roll(img0, (16, 32), axis=(1, 2)))
    cfg = LoFTRConfig(coarse_matching=CoarseMatchingConfig(thr=1e-6, temperature=0.1, border_rm=2,
                                                           border_two_sided=True, max_matches=1024))
    k = 256  # refine slots: random matches, some across the border, the last 24 invalid
    mk0 = rng.uniform(-8, 520, (1, k, 2)).astype(np.float32)
    mk1 = (mk0 + np.array([32.0, 16.0]) + rng.normal(0, 4, mk0.shape)).astype(np.float32)
    mask = np.ones((1, k), bool)
    mask[:, -24:] = False
    out = {}
    for dev in ("cuda", "cpu"):
        model = _loftr(cfg, dev)
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        t0 = time.perf_counter()
        with torch.inference_mode():
            res = (model.match_coarse(t(img0), t(img1)), model.match(t(img0), t(img1)),
                   model.refine(t(img0), t(img1), t(mk0), t(mk1), t(mask), extract_features=True))
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = [{key: v.cpu() if torch.is_tensor(v) else v for key, v in r.items()} for r in res]
        log(f"[8b] LoFTR f32 on {dev}: match_coarse + match + refine in {time.perf_counter() - t0:.2f} s "
            f"(first calls)")
        if dev == "cuda":
            with torch.inference_mode():
                rows, _, _ = device_rows(lambda: model.match_coarse(t(img0), t(img1)), reps=2)
            check_f32_instances(rows, "8b")
    (gc, gm, gr), (cc, cm, cr) = out["cuda"], out["cpu"]
    sg, sc = _pair_sets(gc, 0), _pair_sets(cc, 0)
    common = set(sg) & set(sc)
    jacc = len(common) / max(len(set(sg) | set(sc)), 1)
    mconf = max((abs(float(gc["mconf"][0, sg[p]]) - float(cc["mconf"][0, sc[p]])) for p in common), default=0.0)
    shift = (gc["mkpts1_c"][0] - gc["mkpts0_c"][0])[gc["match_mask"][0]]
    log(f"[8b] match_coarse: {len(sg)} / {len(sc)} matches, jaccard {jacc:.4f} (>= 0.98), mconf max|d| "
        f"{mconf:.2e} (<= 1e-4); median coarse shift {shift.median(0).values.tolist()} px (true (32, 16))")
    key = lambda o, s: tuple(o["mkpts0_c"][0, s].tolist() + o["mkpts1_c"][0, s].tolist())  # noqa: E731
    kg = {key(gm, s): s for s in torch.nonzero(gm["match_mask"][0])[:, 0].tolist()}
    kc = {key(cm, s): s for s in torch.nonzero(cm["match_mask"][0])[:, 0].tolist()}
    both = set(kg) & set(kc)
    mk_match = max(((gm["mkpts1_f"][0, kg[q]] - cm["mkpts1_f"][0, kc[q]]).abs().max().item() for q in both),
                   default=0.0)
    m = torch.from_numpy(mask[0])
    mk_refine = (gr["mkpts1_f"][0][m] - cr["mkpts1_f"][0][m]).abs().max().item()
    feat_rel = max((gr[f] - cr[f]).abs().max().item() / cr[f].abs().max().item()
                   for f in ("feat_coarse_0", "feat_coarse_1", "feat_fine_0", "feat_fine_1"))
    log(f"[8b] match: {len(both)} common fine matches, mkpts1_f max|d| {mk_match:.2e} px (<= 1e-2); refine "
        f"({k} slots): mkpts1_f max|d| {mk_refine:.2e} px (<= 1e-2), sampled features max|d| {feat_rel:.2e} "
        f"of their largest value (<= 1e-4)")
    check(len(common) > 0 and jacc >= 0.98 and mconf <= 1e-4 and len(both) > 0 and mk_match <= 1e-2
          and mk_refine <= 1e-2 and feat_rel <= 1e-4, "the LoFTR matcher on the GPU disagrees with the CPU")


def _plane_object(n_frames: int, img: int, seed: int):
    """Every view renders one textured plane (z = 0) through its plane-induced
    homography (as tests/test_cli_end_to_end.py renders its object), so that
    matches satisfy the epipolar geometry. Returns in-memory frames as
    run_sfm's loader gives them (float32 gray in [0, 1], scale 1) with K,
    world->cam poses and the object's box."""
    import cv2

    rng = np.random.default_rng(seed)
    K, _, Ts = _scene(rng, n_frames, 32, img=float(img))
    tex = (np.kron(rng.random((32, 32)), np.ones((16, 16))) * 255).astype(np.uint8)
    S = np.array([[512 / 0.8, 0, 256], [0, 512 / 0.8, 256], [0, 0, 1.0]])  # plane [-0.4, 0.4]^2 -> texture
    images = {}
    for i, T in enumerate(Ts):
        H = K @ np.stack([T[:3, 0], T[:3, 1], T[:3, 3]], axis=1) @ np.linalg.inv(S)
        images[i] = cv2.warpPerspective(tex, H, (img, img)).astype(np.float32) / 255.0
    corners = np.array([[x, y, z] for z in (-0.3, 0.3) for y in (-0.3, 0.3) for x in (-0.3, 0.3)])
    return images, {i: K for i in images}, {i: Ts[i] for i in images}, corners


def _counted(fn, calls, name):
    def wrapped(*args):
        calls[name] += 1
        return fn(*args)
    return wrapped


def sfm_stages(images, Ks, poses, corners, sc, matcher, device):
    """run_sfm's stages in its order on in-memory frames (no gallery, PLY or h5
    export): pairs, coarse matching, merge, verification + triangulation, the
    post-optimisation (keyframes, refinement pairs, fine refinement, depth
    solve, write-back), filtering, descriptor extraction, annotations. Returns
    the results, the stage walls (s, synchronised), each stage's peak device
    memory (GiB, the peak counter reset before each stage; on the card) and
    the matcher calls."""
    calls = {"coarse": 0, "refine": 0, "extract": 0}
    coarse_fn, refine_fn, extract_fn = make_loftr_fns(matcher)
    coarse_fn = _counted(coarse_fn, calls, "coarse")
    refine_fn = _counted(refine_fn, calls, "refine")
    extract_fn = _counted(extract_fn, calls, "extract")
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    if device == "cuda":
        sync()
        torch.cuda.reset_peak_memory_stats()
    walls, peaks, t = {}, {}, time.perf_counter()

    def lap(name):
        nonlocal t
        sync()
        walls[name] = time.perf_counter() - t
        if device == "cuda":
            peaks[name] = torch.cuda.max_memory_allocated() / 2 ** 30
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()

    n = len(images)
    scales = {i: np.ones(2, np.float32) for i in images}
    sizes = {i: im.shape for i, im in images.items()}
    names = {i: f"{i}.png" for i in images}
    pairs = pose_covisibility_pairs([poses[i] for i in range(n)], num_matched=sc.covis_num,
                                    min_rotation_deg=sc.min_rotation_deg)
    raw = run_pairs(coarse_fn, images, scales, pairs, pair_batch=sc.pair_batch)
    lap("coarse matching")
    scene = merge_keypoints(raw)
    tri = triangulate_scene(scene, Ks, poses, sizes, image_names=names, max_error_px=sc.max_epipolar_error_px,
                            max_reproj_px=sc.max_reproj_error_px, min_tri_angle_deg=sc.min_tri_angle_deg,
                            max_track_length=sc.max_track_length, device=device)
    cameras, imgs, points3d = tri.cameras, tri.images, tri.points3d
    coarse_xyz = {pid: p.xyz.copy() for pid, p in points3d.items()}
    lap("verify + triangulate")
    keyframes, assignment = assign_keyframes_greedy(imgs, points3d)
    ref_pairs = build_refinement_pairs(imgs, points3d, keyframes)
    fine = run_fine_refinement(refine_fn, images, ref_pairs, 1024, sc.pair_batch)
    lap("fine refinement")
    problems = build_depth_problems(cameras, imgs, points3d, assignment, fine, 16)
    check(len(problems["point3d_ids"]) > 0, "no depth problems to solve")
    depths = optimize_depths(problems, solver=sc.solver_type, device=device)
    write_back(cameras, imgs, points3d, assignment, problems["point3d_ids"], depths)
    lap("depth solve (" + sc.solver_type + ")")
    refined = model_stats(cameras, imgs, points3d)
    points3d = filter_by_3d_box(imgs, points3d, corners, sc.box_padding_ratio)
    points3d = filter_track_length(imgs, points3d, track_length_for_budget(points3d, sc.max_num_kp3d))
    points3d = merge_close_points(imgs, points3d, sc.merge_dist_threshold)
    lap("filtering")
    fine_desc, coarse_desc = extract_keypoint_descriptors(extract_fn, images, imgs)
    lap("descriptor extraction")
    anno = build_annotations(imgs, points3d, fine_desc, coarse_descriptors=coarse_desc)
    lap("annotations")
    return {"pairs": pairs, "raw": raw, "coarse_xyz": coarse_xyz, "problems": problems, "depths": depths,
            "refined": refined, "points3d": points3d, "anno": anno, "walls": walls, "peaks": peaks,
            "calls": calls}


def phase8c(smi: str):
    """The SfM configuration at full width on the card: 20 frames of 512^2."""
    cfg = load_config(str(CONFIGS_DIR), ["+preprocess=sfm_inference_onepose", "dataset.down_ratio=1",
                                         "model.match_coarse.thr=0.000001"])
    sc = sfm_config(cfg)
    check(cfg.model["compute_dtype"] == "bfloat16" and sc.pair_batch == 8 and sc.solver_type == "lm",
          "phase 8c is the bf16, pair batch 8, LM configuration")
    images, Ks, poses, corners = _plane_object(20, 512, seed=82)
    torch.backends.cudnn.benchmark = False
    matcher = build_loftr_matcher(dict(cfg.model), device="cuda")
    matcher.load_state_dict(random_state_dict(matcher, seed=666))
    check(matcher.cfg.coarse_matching.max_matches == 1024, "1024 match slots")
    # set-up, timed apart from the stages: one call of each matcher surface at
    # the stages' shapes (cuDNN's first choice of algorithms, first launches)
    coarse_fn, refine_fn, extract_fn = make_loftr_fns(matcher)
    pair_imgs = np.stack([images[0][..., None]] * sc.pair_batch)
    slots = np.zeros((sc.pair_batch, 1024, 2), np.float32)
    kpts = np.zeros((sc.pair_batch, 4096, 2), np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coarse_fn(pair_imgs, pair_imgs)
    refine_fn(pair_imgs, pair_imgs, slots, slots, slots[..., 0] > 0)
    extract_fn(pair_imgs, kpts, kpts[..., 0] > 0)
    torch.cuda.synchronize()
    log(f"[8c] set-up: first calls of the three matcher surfaces {time.perf_counter() - t0:.3f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res = sfm_stages(images, Ks, poses, corners, sc, matcher, "cuda")
    counts = kernels.launch_counts()
    peak = max(res["peaks"].values())  # the stages reset the counter: the largest stage's peak
    calls = res["calls"]
    per_forward = 2 * len(matcher.cfg.coarse.layer_sequence)  # both streams of every coarse layer
    expected = {"K1_encoder_layer": per_forward * sum(calls.values()), "K2_rowcol_stats": calls["coarse"],
                "K3_window_gather": 0, "K4_window_scatter": 0, "K5_coarse_loss": 0, "K5_coarse_loss_bwd": 0,
                "K6_patch_gather": 2 * calls["refine"],  # descriptor extraction gathers no window
                "K7_short_encoder": 0}
    log(f"[8c] matcher calls {calls}; launches {counts} (expected {expected})")
    check(counts == expected, "a kernel of the SfM path was not launched as the calls imply")
    n_matches = sum(len(pm.conf) for pm in res["raw"])
    st = res["refined"]  # model statistics after the depth solve
    pts = np.array([p.xyz for p in res["points3d"].values()]).reshape(-1, 3)
    anno = res["anno"]
    finite = (np.isfinite(pts).all() and np.isfinite(res["depths"]).all()
              and np.isfinite(anno["descriptors3d"]).all() and np.isfinite(anno["descriptors3d_coarse"]).all())
    walls = res["walls"]
    log(f"[8c] SfM bf16, {len(images)} frames of 512^2, pair batch {sc.pair_batch}, 1024 slots, "
        f"{sc.solver_type}: {len(res['pairs'])} pairs, {n_matches} coarse matches, after the depth solve "
        f"{st['num_points3D']} points, mean track length {st['mean_track_length']:.3f}, mean reprojection "
        f"error {st['mean_reprojection_error']:.3f} px; {len(pts)} points after filtering, annotations of "
        f"{len(anno['anno_2d'])} frames; peak memory {peak:.2f} GiB, on {smi}")
    log("[8c] stage walls (s, synchronised): " + ", ".join(f"{k} {v:.3f}" for k, v in walls.items())
        + f"; total {sum(walls.values()):.3f}")
    log("[8c] peak memory by stage (GiB, the counter reset before each): "
        + ", ".join(f"{k} {v:.2f}" for k, v in res["peaks"].items()) + f"; on {smi}")
    log(f"[8c] match_coarse: {len(res['pairs']) / walls['coarse matching']:.2f} pairs/s "
        f"({calls['coarse']} calls of {sc.pair_batch} pairs)")
    check(bool(finite) and len(pts) > 0 and st["num_points3D"] > 0, "the SfM run gave no finite points")
    phase8c_extraction(matcher, pair_imgs, smi)
    return counts


def phase8c_extraction(matcher: LoFTRMatcher, pair_imgs: np.ndarray, smi: str) -> None:
    """Descriptor extraction at its shape (8 frames of 512^2, 4096 keypoint
    slots) before and after it stopped running the fine stage: the self-pair
    refine that the surface called before (windows, fine transformer,
    soft-argmax, all unread) against ``extract``, each call's wall
    (synchronised, median of 3) and peak device memory, and the two outputs
    bitwise equal."""
    rng = np.random.default_rng(83)
    img = torch.from_numpy(np.ascontiguousarray(pair_imgs)).cuda()
    kpts = torch.from_numpy(rng.uniform(0, 512, (pair_imgs.shape[0], 4096, 2)).astype(np.float32)).cuda()
    mask = torch.ones(kpts.shape[:2], dtype=torch.bool, device="cuda")
    calls = {"refine (self pair, fine stage)": lambda: matcher.refine(img, img, kpts, kpts, mask, extract_features=True),
             "extract": lambda: matcher.extract(img, kpts)}
    rec = {}
    with torch.inference_mode():
        for tag, fn in calls.items():
            out = fn()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            rec[tag] = (float(np.median(walls)), torch.cuda.max_memory_allocated() / 2 ** 30, out)
            del out
    (w0, p0, ref), (w1, p1, (fine, coarse)) = rec.values()
    same = torch.equal(fine, ref["feat_fine_0"]) and torch.equal(coarse, ref["feat_coarse_0"])
    log(f"[8c] descriptor extraction, {pair_imgs.shape[0]} frames of 512^2 x 4096 keypoints: the self-pair refine "
        f"(before) {w0:.4f} s, peak {p0:.2f} GiB; extract (now) {w1:.4f} s, peak {p1:.2f} GiB; outputs bitwise "
        f"equal {same}; on {smi}")
    check(same, "extract and the self-pair refine give different descriptors")


def phase8d() -> None:
    """The same stages in f32 on a 6-frame object of 256^2: GPU against CPU."""
    no_tf32()
    cfg = load_config(str(CONFIGS_DIR), ["+preprocess=sfm_inference_onepose", "dataset.down_ratio=1",
                                         "model.match_coarse.thr=0.000001", "model.compute_dtype=float32"])
    sc = sfm_config(cfg)
    images, Ks, poses, corners = _plane_object(6, 256, seed=83)
    res = {}
    for dev in ("cuda", "cpu"):
        matcher = build_loftr_matcher(dict(cfg.model), device=dev)
        matcher.load_state_dict(random_state_dict(matcher, seed=666))
        res[dev] = sfm_stages(images, Ks, poses, corners, sc, matcher, dev)
        if dev == "cuda":  # the coarse matching stage's call on one pair of these frames
            im = lambda i: torch.from_numpy(images[i][None, ..., None]).to(dev)  # noqa: E731
            with torch.inference_mode():
                rows, _, _ = device_rows(lambda: matcher.match_coarse(im(0), im(1)), reps=2)
            check_f32_instances(rows, "8d")
        log(f"[8d] f32 stages on {dev}: " + ", ".join(f"{k} {v:.2f} s" for k, v in res[dev]["walls"].items()))
    g, c = res["cuda"], res["cpu"]
    jacc = []
    for pg, pc in zip(g["raw"], c["raw"]):
        key = lambda pm: {tuple(np.round(np.r_[a, b], 3)) for a, b in zip(pm.pts0, pm.pts1)}  # noqa: E731
        a, b = key(pg), key(pc)
        jacc.append(len(a & b) / max(len(a | b), 1))
    n_g, n_c = len(g["coarse_xyz"]), len(c["coarse_xyz"])
    common = sorted(set(g["coarse_xyz"]) & set(c["coarse_xyz"]))
    dxyz = np.median([np.abs(g["coarse_xyz"][p] - c["coarse_xyz"][p]).max() for p in common]) if common else np.inf
    ids_g = {int(p): d for p, d in zip(g["problems"]["point3d_ids"], g["depths"])}
    ids_c = {int(p): d for p, d in zip(c["problems"]["point3d_ids"], c["depths"])}
    both = sorted(set(ids_g) & set(ids_c))
    ddep = np.median([abs(ids_g[p] - ids_c[p]) / ids_c[p] for p in both]) if both else np.inf
    log(f"[8d] GPU vs CPU: {len(g['raw'])} pairs, per-pair match jaccard min {min(jacc):.4f} (>= 0.98), "
        f"points {n_g} vs {n_c} (within 2 %), median |dxyz| {dxyz:.2e} (<= 1e-3), refined depths of "
        f"{len(both)} tracks median relative |d| {ddep:.2e} (<= 1e-3)")
    check(min(jacc) >= 0.98 and n_c > 0 and abs(n_g - n_c) <= 0.02 * n_c and dxyz <= 1e-3 and ddep <= 1e-3,
          "the f32 SfM stages on the GPU disagree with the CPU")


# LoFTR's outdoor dual-softmax matcher (benchmark/configs/loftr_outdoor_ds.json's model), at thr 1e-6
# so that random weights give matches
OUTDOOR_MODEL = {
    "compute_dtype": "bfloat16", "d_model": 256, "nhead": 8, "layer_iter_n": 4, "temp_bug_fix": True,
    "match_coarse": {"thr": 1e-6, "dsmax_temperature": 0.1, "border_rm": 2, "max_matches": 5120},
    "fine_window_size": 5, "fine_concat_coarse_feat": True,
}
MD_LONG, MD_SHORT = 1200, 800  # MegaDepth-1500's views: longer side 1200, each padded to 1200^2


def _md_masks():
    """Coarse masks [22500] of a landscape (1200 x 800) and a portrait (800 x 1200) view padded
    bottom-right to 1200^2: 150 x 150 cells, 15 000 of them valid."""
    side, short = MD_LONG // 8, MD_SHORT // 8
    land = torch.zeros(side, side, dtype=torch.bool, device="cuda")
    port = torch.zeros_like(land)
    land[:short] = True
    port[:, :short] = True
    return land.reshape(-1), port.reshape(-1)


def phase8m(gen, smi: str) -> None:
    """LoFTR outdoor's padded path at MegaDepth-1500 shapes: K1 masked (bf16)
    at [4, 22500, 256], self and cross, and K2 with row and column masks at
    [4, 22500] x [4, 22500], against their plain versions; then one batch of
    run_pairs through the full-match surface on 1200 x 800 and 800 x 1200
    views, its launches counted from 0."""
    land, port = _md_masks()
    m0 = torch.stack([land, port, land, port])
    m1 = torch.stack([port, port, land, land])
    n, l, c = 4, MD_LONG ** 2 // 64, 256
    check(k1_instance(c, 8, torch.bfloat16) == "tc", "K1 at C = 256 in bf16 is not the tc instance")
    for tag, cross in (("self", False), ("cross", True)):
        x, src, w = _encoder_inputs(gen, l, l if cross else None, n=n)
        masks = {"x_mask": m0, "source_mask": m1 if cross else m0}
        wb = {k: (_bf16(v) if v.dim() == 2 else v) for k, v in w.items()}
        got = fused_encoder_layer(x, src, **wb, **masks, nhead=8, dtype=torch.bfloat16)
        ref = encoder_layer_plain(x, src, **wb, **masks, nhead=8, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        d = (got - ref).abs()
        packed = pack_encoder_weights(**wb, nhead=8, dtype=torch.bfloat16)
        ms = time_ms(lambda: fused_encoder_layer_packed(x, src, packed, masks["x_mask"], masks["source_mask"]))
        log(f"[8m] K1 tc masked {tag} x{tuple(x.shape)} src{tuple(src.shape)}: max|d| {d.max().item():.3e} "
            f"(<= 5e-2), mean|d| {d.mean().item():.3e} (<= 5e-3) against the plain bf16 layer; "
            f"{ms:.3f} ms a call with packed weights (median of 20)")
        check(d.max().item() <= 5e-2 and d.mean().item() <= 5e-3 and bool(torch.isfinite(got).all()),
              f"K1 masked {tag} at the MegaDepth shape disagrees")
        del x, src, got, ref, d
    f0 = torch.randn(n, l, c, generator=gen, device="cuda")
    f1 = torch.randn(n, l, c, generator=gen, device="cuda")
    row_add, col_add = torch.where(m0, 0.0, -1e9), torch.where(m1, 0.0, -1e9)
    got = dual_softmax_rowcol_stats(f0, f1, 0.1, row_add=row_add, col_add=col_add, dtype=torch.bfloat16)
    lse, agree, padded = 0.0, 1.0, 0
    for i in range(n):  # one pair at a time: a pair's dense f32 similarity is 2 GB
        ref = rowcol_stats_plain((f0[i:i + 1] * c ** -0.5).to(torch.bfloat16),
                                 (f1[i:i + 1] * c ** -0.5).to(torch.bfloat16), 1 / (0.1 + 1e-4),
                                 row_add[i:i + 1], col_add[i:i + 1])
        rows, cols = m0[i], m1[i]
        for k, at in (("row_lse", rows), ("row_best_val", rows), ("col_lse", cols), ("col_best_val", cols)):
            lse = max(lse, (got[k][i][at] - ref[k][0][at]).abs().max().item())
        agree = min(agree, (got["row_best_j"][i][rows] == ref["row_best_j"][0][rows]).float().mean().item(),
                    (got["col_best_p"][i][cols] == ref["col_best_p"][0][cols]).float().mean().item())
        padded += int((~m1[i][got["row_best_j"][i][rows].long()]).sum() + (~m0[i][got["col_best_p"][i][cols].long()]).sum())
        del ref
    ms = time_ms(lambda: dual_softmax_rowcol_stats(f0, f1, 0.1, row_add=row_add, col_add=col_add,
                                                   dtype=torch.bfloat16))
    log(f"[8m] K2 tc with row_add and col_add, f0{tuple(f0.shape)} f1{tuple(f1.shape)}: at the valid rows and "
        f"columns LSE and best values max|d| {lse:.3e} (<= 2e-3), argmax agree {agree:.6f} (>= 0.999), "
        f"{padded} best indices in padding (0); {ms:.3f} ms a call (median of 20)")
    check(lse <= 2e-3 and agree >= 0.999 and padded == 0, "K2 with both masks at the MegaDepth shape disagrees")
    del f0, f1, got
    torch.cuda.empty_cache()

    matcher = loftr_matcher_from_dict(OUTDOOR_MODEL).eval().to("cuda")
    matcher.load_state_dict(random_state_dict(matcher, seed=667))
    sq = _textured_images(np.random.default_rng(88), 1, MD_LONG)[0]
    lo = (MD_LONG - MD_SHORT) // 2
    land_img, port_img = sq[lo:lo + MD_SHORT], np.ascontiguousarray(sq[:, lo:lo + MD_SHORT])
    images = {0: land_img, 1: port_img, 2: land_img.copy(), 3: port_img.copy()}
    scales = {i: np.ones(2) for i in images}
    pairs = [(0, 1), (1, 2), (2, 3), (3, 0)]
    match_fn = make_loftr_match_fn(matcher)
    run_pairs(match_fn, images, scales, pairs, pair_batch=4)  # cuDNN's first choice, first launches
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    raw = run_pairs(match_fn, images, scales, pairs, pair_batch=4)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    expected = {"K1_encoder_layer": 2 * len(matcher.cfg.coarse.layer_sequence), "K2_rowcol_stats": 1,
                "K3_window_gather": 2, "K4_window_scatter": 0, "K5_coarse_loss": 0, "K5_coarse_loss_bwd": 0,
                "K6_patch_gather": 0, "K7_short_encoder": 0}
    bd, inside = matcher.cfg.coarse_matching.border_rm * 8, True
    for pm, (i, j) in zip(raw, pairs):
        (h0, w0), (h1, w1) = images[i].shape, images[j].shape
        inside &= bool(((pm.pts0 >= bd) & (pm.pts0 < np.array([w0, h0]) - bd)).all())
        inside &= bool(((pm.pts1 >= bd - 4) & (pm.pts1 < np.array([w1, h1]) - bd + 4)).all())
    n_matches = [len(pm.conf) for pm in raw]
    finite = all(np.isfinite(pm.pts1).all() and np.isfinite(pm.conf).all() for pm in raw)
    log(f"[8m] run_pairs through make_loftr_match_fn, 4 pairs of 1200x800 and 800x1200 views padded to 1200^2 "
        f"(bf16, 5120 slots, thr 1e-6, random weights): launches K1 {counts['K1_encoder_layer']}, K2 "
        f"{counts['K2_rowcol_stats']}, K3 {counts['K3_window_gather']} (all counts {counts}; expected {expected}); "
        f"matches a pair {n_matches}, every match inside its view's valid extent less the border band {inside}, "
        f"finite {finite}; one batch {wall:.3f} s ({len(pairs) / wall:.2f} pairs/s, synchronised), on {smi}")
    check(counts == expected, "a kernel of the padded full-match path was not launched as one call implies")
    check(inside and finite and min(n_matches) > 0, "the padded full-match path gave matches outside the views")
    del matcher, match_fn
    torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 9

def phase8e(smi: str) -> None:
    """The incremental SfM (unknown poses) on a synthetic ring scene with
    simulated matches, on the card and on the CPU: every view registered, both
    trajectories within 0.02 of the truth (ATE) and of each other."""
    n_views = 6
    K, pts, Ts = _scene(np.random.default_rng(3), n_views, 60)
    rng = np.random.default_rng(3)  # the matches of tests/test_torch_incremental_sfm.py's scene
    raw = []
    for i in range(n_views):
        for j in range(i + 1, n_views):
            keep = rng.random(len(pts)) >= 0.1
            uv = [(p[:, :2] / p[:, 2:3]) @ K[:2, :2].T + K[:2, 2]
                  for p in (pts @ Ts[k][:3, :3].T + Ts[k][:3, 3] for k in (i, j))]
            raw.append(PairMatches((i, j), uv[0][keep] + rng.normal(0, 0.3, (keep.sum(), 2)),
                                   uv[1][keep] + rng.normal(0, 0.3, (keep.sum(), 2)),
                                   rng.uniform(0.5, 1.0, keep.sum())))
    scene = merge_keypoints(raw)
    Ks = {i: K for i in range(n_views)}
    # the first cuSOLVER calls of a process load and set it up; phases 3-8
    # have made them already, so these read the calls alone
    eye = torch.eye(9, device="cuda").expand(4, 9, 9).contiguous()
    first = {}
    for name, fn in (("eigh", torch.linalg.eigh), ("svd", torch.linalg.svd), ("solve_ex", lambda a: torch.linalg.solve_ex(a, a))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(eye)
        torch.cuda.synchronize()
        first[name] = time.perf_counter() - t0
    log("[8e] batched " + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in first.items()) + " on [4, 9, 9] here")
    out, walls = {}, {}
    for tag, dev in (("card", "cuda"), ("card, second call", "cuda"), ("cpu", "cpu")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[tag] = incremental_sfm(scene, Ks, min_seed_matches=30, device=dev)
        walls[tag] = time.perf_counter() - t0
    centers = {k: camera_centers_from_poses(np.stack([o["poses"][i] for i in range(n_views)]))
               for k, o in out.items() if len(o["registered"]) == n_views}
    check(len(centers) == 3, f"a view was not registered: {[o['registered'] for o in out.values()]}")
    gt = camera_centers_from_poses(Ts)
    ate = {k: absolute_trajectory_error(c, gt)["ate_rmse"] for k, c in centers.items()}
    between = absolute_trajectory_error(centers["card"], centers["cpu"])["ate_rmse"]
    log(f"[8e] incremental SfM, {n_views} views, {len(out['card']['points'])} points on the card "
        f"({len(out['cpu']['points'])} on the CPU): registration order {out['card']['registered']}; ATE to the "
        f"truth card {ate['card']:.4f}, CPU {ate['cpu']:.4f}, card to CPU {between:.4f} (threshold 0.02)")
    log(f"[8e] walls: first call on the card {walls['card']:.3f} s (RANSAC, PnP, LM on closed-form "
        f"Jacobians), second {walls['card, second call']:.3f} s, CPU {walls['cpu']:.3f} s, on {smi}")
    check(max(ate.values()) < 0.02 and between < 0.02, "the incremental SfM's trajectory is off")


FINE_SHAPES = ((1, 1), (25, 25), (1, 25), (25, 1))  # (L, S) of the fine transformer's layer applications


def k7_bound(m: int, l: int, s: int, c: int, self_attention: bool, dtype: torch.dtype) -> dict:
    """K7's least time: x read once (and a source of its own, unless x is the
    source), y written once, both f32; the weights read once in the operand
    type; the products: Q, merge and the FFN (8 C^2 multiply-adds a query
    row), K and V (2 C^2 a source row), scores and A.V (2 L S C a sequence)."""
    n_bytes = 4 * m * c * (2 * l + (0 if self_attention else s)) + 10 * c * c * (2 if dtype == torch.bfloat16 else 4) + 16 * c
    return bound(n_bytes, 2 * m * c * c * (8 * l + 2 * s) + 4 * m * l * s * c, dtype)


def _short_inputs(gen, m, l, s, c=128):
    """x [m, l, c] and its source (x itself for a self layer, l == s), with
    the weights of one layer ([in, out] layout)."""
    x = torch.randn(m, l, c, generator=gen, device="cuda")
    return x, (x if l == s else torch.randn(m, s, c, generator=gen, device="cuda")), _layer_weights(gen, c)


K7_PREVIOUS_MS = 7.428  # bf16 [8192, 25, 128] self on the CUDA cores (NVIDIA H100 80GB HBM3, 700.00 W)
K7_TC_NAMES = ("short_encoder_tc_kernel",)  # bf16 operands at C = 128: the tensor cores
K7_CC_NAMES = ("short_encoder_kernel",)  # f32 operands (and other widths): the CUDA cores


def phase9a(gen) -> dict:
    """K7 at the fine transformer's shapes: M 8192 sequences (a frame batch of
    16 x 512 slots), timed, and M 8189 (not a multiple of 8), checked. bf16
    operands run the tensor-core instance (by kernel name, and no CUDA-core K7
    kernel), two launches bitwise equal; f32 operands the CUDA-core one."""
    rec = {}
    for m in (8189, 8192):
        for l, s in FINE_SHAPES:
            x, src, w = _short_inputs(gen, m, l, s)
            for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                packed = pack_short_encoder_weights(**w, nhead=8, dtype=dtype)
                call = lambda: fused_short_encoder_layer_packed(x, src, packed)  # noqa: E731
                got = call()
                again = call()
                ref = short_encoder_layer_plain(x, src, **w, nhead=8, dtype=dtype)
                torch.cuda.synchronize()
                d = (got - ref).abs()
                same = torch.equal(got, again)
                d_max = d.max().item()
                # f32: summation order only; bf16: a rounded operand may land
                # on the neighbouring bf16 value and move its row by ~1e-2
                tol = (1e-4, 1e-5) if dtype == torch.float32 else (5e-2, 5e-4)
                log(f"[9a] K7 {dt} x{tuple(x.shape)} src{tuple(src.shape)}{' (self)' if src is x else ''}: "
                    f"max|d| {d.max().item():.3e} (<= {tol[0]:g}), mean|d| {d.mean().item():.3e} "
                    f"(<= {tol[1]:g}), two launches bitwise equal {same}")
                check(got.shape == x.shape and got.dtype == torch.float32 and d.max().item() <= tol[0]
                      and d.mean().item() <= tol[1] and same, f"K7 {dt} ({l}, {s}) M {m} disagrees")
                rows, busy, _ = device_rows(call, reps=3)
                names = {_short(r[2]) for r in rows}
                want = K7_TC_NAMES if dtype == torch.bfloat16 else K7_CC_NAMES
                check(names == set(want), f"K7 {dt} ({l}, {s}) launched {sorted(names)}, expected {want}")
                del got, again, ref, d
                if m != 8192:
                    continue
                ms = time_ms(call)
                loose = time_ms(lambda: fused_short_encoder_layer(x, src, **w, nhead=8, dtype=dtype))
                pms = time_ms(lambda: short_encoder_layer_plain(x, src, **w, nhead=8, dtype=dtype))
                dev = busy / sum(r[1] for r in rows)
                b = k7_bound(m, l, s, 128, src is x, dtype)
                log(f"[9a] K7 {dt} (L, S) = ({l}, {s}), M {m}: kernel {ms:.4f} ms with packed weights "
                    f"({loose:.4f} ms packing loose weights at the call), device {dev:.4f} ms a launch "
                    f"({launch_names(rows)}), plain {pms:.3f} ms (median of 20); bound {b['bound_ms']:.4f} ms "
                    f"({b['bound_by']}, {'989 TFLOP/s bf16' if dt == 'bf16' else '67 TFLOP/s f32'}): "
                    f"{ms / b['bound_ms']:.1f}x it")
                rec[(l, s, dt)] = {"ms": ms, "plain_ms": pms, "max_abs_err": d_max, **b}
    for dt in ("f32", "bf16"):
        tot = {k: sum(rec[(l, s, dt)][k] for l, s in FINE_SHAPES) for k in ("ms", "plain_ms", "bound_ms")}
        log(f"[9a] K7 {dt}, the four shapes of one (self, cross) pair at M 8192: kernel {tot['ms']:.3f} ms, "
            f"plain {tot['plain_ms']:.3f} ms, bound {tot['bound_ms']:.4f} ms")
    log(f"[9a] K7 bf16 [8192, 25, 128] self: {rec[(25, 25, 'bf16')]['ms']:.4f} ms ({K7_PREVIOUS_MS} ms on the "
        f"CUDA cores); no single PyTorch call computes an encoder layer over many short sequences")
    return {**rec[(25, 25, "bf16")], "library_ms": None}


def phase9b(gen, smi: str) -> int:
    """The fine transformer of the bf16 model (random weights) through K7
    against the port's eager fine transformer, on the fine stage's streams."""
    model = _model(OnePosePlusConfig(compute_dtype="bfloat16"), "cuda")
    fine = model.loftr_fine
    check(fine.cfg.layer_sequence == ("self", "cross") and fine.cfg.d_model == 128,
          "the fine transformer is one (self, cross) pair at 128 channels")
    launches = None
    with torch.inference_mode():
        for m, what in ((8192, "frame batch 16"), (24576, "bench.py's batch 48")):
            f0 = torch.randn(m, 1, 128, generator=gen, device="cuda").to(torch.bfloat16)
            f1 = torch.randn(m, 25, 128, generator=gen, device="cuda").to(torch.bfloat16)
            kernels.reset_launch_counts()
            k0, k1 = fine_transformer_short(fine, f0, f1)
            e0, e1 = fine(f0, f1)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            expected = {k: (4 if k == "K7_short_encoder" else 0) for k in counts}
            check(counts == expected, f"the fine transformer through K7 launched {counts}, expected {expected}")
            if launches is None:
                launches = counts["K7_short_encoder"]
            d = torch.cat([(k0 - e0.float()).abs().flatten(), (k1 - e1.float()).abs().flatten()])
            finite = bool(torch.isfinite(k0).all() and torch.isfinite(k1).all())
            scale = max(e0.float().abs().max().item(), e1.float().abs().max().item())
            # the eager layers return bf16 streams, K7 f32 ones: they differ by
            # bf16 rounding of the streams (values up to ~scale), not by a bug
            log(f"[9b] fine transformer through K7 vs eager (bf16), f0[{m}, 1, 128] f1[{m}, 25, 128] ({what}): "
                f"launches {counts['K7_short_encoder']} (4), max|d| {d.max().item():.3e} (<= 0.25), mean|d| "
                f"{d.mean().item():.3e} (<= 1e-2), largest |value| {scale:.2f}, finite {finite}")
            check(finite and d.max().item() <= 0.25 and d.mean().item() <= 1e-2,
                  f"the fine transformer through K7 disagrees with the eager one at M {m}")
            del k0, k1, e0, e1, d
            ms_k = time_ms(lambda: fine_transformer_short(fine, f0, f1))
            ms_e = time_ms(lambda: fine(f0, f1))
            log(f"[9b] M {m}: through K7 {ms_k:.3f} ms, eager {ms_e:.3f} ms (CUDA-event medians of 20), "
                f"on {smi}")
    del model
    return launches


def phase9c(smi: str) -> None:
    """bench.py's step in-process at its defaults (48 frames of 512^2, 7000
    points, 512 slots, bf16, 32 timed steps after one warm-up)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    record = bench.main()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = 33
    expected = {k: 0 for k in counts} | {"K1_encoder_layer": 12 * steps, "K2_rowcol_stats": steps,
                                         "K3_window_gather": steps}
    log(f"[9c] bench line above: {record['value']} poses/s, peak memory {peak:.2f} GiB; launches {counts} "
        f"(expected {expected} for {steps} steps), on {smi}")
    check(counts == expected and record["value"] > 0, "the bench step did not run the kernels as it implies")


def _video_object(root: str, obj: str, n_frames: int, blank=(), img: int = 512, seed: int = 0):
    """A OnePose-format object (one sequence, ``color``, ``intrin_ba``,
    ``poses_ba``, ``box3d_corners.txt``): a textured plane (z = 0, 1.2 m wide)
    that fills every frame, seen from 1 m by a camera orbiting it 1 degree a
    frame, as a video moves; each view rendered through its plane-induced
    homography. Frames in ``blank`` are black (the object occluded). Returns
    the frames [n, img, img] in [0, 1], K and the world->camera poses."""
    import cv2

    rng = np.random.default_rng(seed)
    K = np.array([[500.0, 0, img / 2], [0, 500.0, img / 2], [0, 0, 1.0]])
    tex = (np.kron(rng.random((48, 48)), np.ones((16, 16))) * 255).astype(np.uint8)
    S = np.array([[768 / 1.2, 0, 384], [0, 768 / 1.2, 384], [0, 0, 1.0]])  # plane metres -> texture pixels
    seq = os.path.join(root, obj, obj.split("-", 1)[1] + "-1")
    for sub in ("color", "intrin_ba", "poses_ba"):
        os.makedirs(os.path.join(seq, sub), exist_ok=True)
    frames, poses = [], []
    for i in range(n_frames):
        a = np.deg2rad(i)
        center = np.array([np.sin(a), 0.0, -np.cos(a)])
        z = -center
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        T = np.eye(4)
        T[:3, :3] = np.stack([x, np.cross(z, x), z])
        T[:3, 3] = -T[:3, :3] @ center
        H = K @ np.stack([T[:3, 0], T[:3, 1], T[:3, 3]], axis=1) @ np.linalg.inv(S)
        frame = np.zeros((img, img), np.uint8) if i in blank else cv2.warpPerspective(tex, H, (img, img))
        cv2.imwrite(os.path.join(seq, "color", f"{i:04d}.png"), frame)  # the CLIs read frames in name order
        np.savetxt(os.path.join(seq, "intrin_ba", f"{i:04d}.txt"), K)
        np.savetxt(os.path.join(seq, "poses_ba", f"{i:04d}.txt"), T)
        frames.append(frame.astype(np.float32) / 255.0)
        poses.append(T)
    box = np.array([[x, y, z] for z in (-0.05, 0.05) for y in (-0.45, 0.45) for x in (-0.45, 0.45)])
    np.savetxt(os.path.join(root, obj, "box3d_corners.txt"), box)
    return np.stack(frames), K, np.stack(poses)


def _own_feature_annotation(model, frames, K, poses, refs, n_pts: int, path: str, seed: int = 0) -> dict:
    """``anno_3d_average.npz`` (and ``_coarse``) for a ``_video_object`` whose
    descriptors are ``model``'s own features: ``n_pts`` points on the plane,
    split among the reference frames ``refs``, each described by the
    backbone's fine feature and its coarse feature (with the sine PE, less
    the keypoint encoding the model adds to the 3D side) at the point's
    projection in its reference frame. It stands in for an SfM annotation
    that a random-weight matcher can match, so that poses can be held to GT.
    Returns the point cloud as the query step takes it."""
    rng = np.random.default_rng(seed)
    dev = next(model.parameters()).device
    pts, coarse, fine = [], [], []
    with torch.inference_mode():
        for r in refs:
            fc, ff = model.backbone(torch.from_numpy(frames[r])[None, ..., None].to(dev))
            fc = sine_position_encoding(fc, model.cfg.pe_temp_bug_fix)
            p = np.c_[rng.uniform(-0.45, 0.45, (n_pts // len(refs), 2)), np.zeros(n_pts // len(refs))]
            pc = p @ poses[r][:3, :3].T + poses[r][:3, 3]
            uv = pc[:, :2] / pc[:, 2:3] @ K[:2, :2].T + K[:2, 2]

            def at(fmap, stride):  # the [1, h, w, c] map's feature at each point's cell
                x, y = torch.from_numpy(np.clip(uv // stride, 0, [fmap.shape[2] - 1, fmap.shape[1] - 1])
                                        .astype(np.int64).T).to(dev)
                return fmap[0, y, x].float()

            coarse.append(at(fc, 8))  # the backbone's 1/8 and 1/2 maps
            fine.append(at(ff, 2))
            pts.append(p)
        kp = torch.from_numpy(np.concatenate(pts).astype(np.float32)).to(dev)
        coarse = torch.cat(coarse) - model.kpt_3d_pos_encoding.encoder(normalize_3d_keypoints(kp[None]))[0]
    cloud = {"keypoints3d": kp, "descriptors3d": torch.cat(fine), "descriptors3d_coarse": coarse}
    arrays = {k: v.cpu().numpy() for k, v in cloud.items()}
    scores = np.ones(len(kp), np.float32)
    save_3d_annotation(path, arrays["keypoints3d"], arrays["descriptors3d"], scores)
    save_3d_annotation(path.replace(".npz", "_coarse.npz"), arrays["keypoints3d"], arrays["descriptors3d_coarse"],
                       scores)
    return cloud


def _cli_model(cfg):
    """The model a CLI builds from ``cfg`` without weights: random, seed 666."""
    model = build_onepose_model(dict(cfg.get("model", {}) or {}), device="cuda")
    model.load_state_dict(random_state_dict(model, seed=666))
    return model


def _pose_errors(poses, gt):
    r, t = batched_pose_errors(torch.as_tensor(np.asarray(poses, np.float32)),
                               torch.as_tensor(np.asarray(gt, np.float32)))
    return r.numpy(), t.numpy()


def phase9d(tmp: str, smi: str) -> None:
    """The inference CLI at full width (inference_onepose.yaml: bf16, frame
    batch 16) on a 32-frame object of 512^2 and a 7000-point annotation."""
    n, obj = 32, "0001-plane"
    out = os.path.join(tmp, "results")
    cfg = load_config(str(CONFIGS_DIR), [
        "+experiment=inference_onepose", "ids=null", f"dataset.data_dir={tmp}/data",
        f"dataset.sfm_outputs_dir={tmp}/sfm", f"output_dir={out}", "model.match_coarse.thr=0.0"])
    check(cfg.model["compute_dtype"] == "bfloat16" and cfg.get("device", "cuda") == "cuda", "9d runs bf16 on cuda")
    frames, K, poses = _video_object(os.path.join(tmp, "data"), obj, n)
    _own_feature_annotation(_cli_model(cfg), frames, K, poses, (0, 8, 16, 24), 7000,
                            os.path.join(tmp, "sfm", obj, "anno", "anno_3d_average.npz"))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    inference_cli.inference(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    steps = -(-n // cfg.inference.frame_batch)
    expected = {k: 0 for k in counts} | {"K1_encoder_layer": 12 * steps, "K2_rowcol_stats": steps,
                                         "K3_window_gather": steps}
    errors = json.loads(Path(out, f"errors_{obj}.json").read_text())
    metrics = Path(out, "metrics.txt").read_text().splitlines()
    summary = json.loads(metrics[-1].removeprefix("ALL: "))
    log(f"[9d] inference CLI, {n} frames of 512^2, bf16: {wall:.3f} s wall (model built, weights drawn, first "
        f"step's set-up included), files {sorted(os.listdir(out))}, launches {counts} (expected {expected}), "
        f"matches median {int(np.median(errors['num_matches']))}, inliers median "
        f"{int(np.median(errors['num_inliers']))}, on {smi}")
    r_med, t_med = np.median(errors["R_errs_deg"]), np.median(errors["t_errs_cm"])
    # a pose from random matches misses by tens of degrees and ~1 m
    log(f"[9d] against GT: R err median {r_med:.3f} deg (<= 5), t err median {t_med:.3f} cm (<= 5); "
        f"{metrics[-1]}")
    check(counts == expected, "the inference CLI did not run the kernels as its steps imply")
    check(len(errors["frames"]) == n and r_med <= 5 and t_med <= 5 and "5cm@5degree" in summary
          and set(errors) == {"frames", "R_errs_deg", "t_errs_cm", "num_inliers", "num_matches"},
          "the inference CLI's files are incomplete or its poses miss the GT")


def phase9e(tmp: str, smi: str) -> None:
    """The tracking demo at full width (inference_demo.yaml: f32) on 30 frames
    of 512^2, every third frame blank (the object occluded: tracking is lost
    and the next frame goes to the detector), 15 DB views."""
    n, obj = 30, "0002-plane"
    blank = set(range(2, n, 3))
    frames_dir, video = os.path.join(tmp, "frames"), os.path.join(tmp, "demo.mp4")
    cfg = load_config(str(CONFIGS_DIR), [
        "+experiment=inference_demo", f"dataset.data_dir={tmp}/demo_data", f"dataset.sfm_outputs_dir={tmp}/demo_sfm",
        f"demo.frames_dir={frames_dir}", f"demo.output_video={video}", "model.match_coarse.thr=0.0"])
    frames, K, poses = _video_object(os.path.join(tmp, "demo_data"), obj, n, blank=blank, seed=1)
    sfm = os.path.join(tmp, "demo_sfm", obj)
    model = _cli_model(cfg)
    cloud = _own_feature_annotation(model, frames, K, poses, (0, 9, 18, 27), 7000,
                                    os.path.join(sfm, "anno", "anno_3d_average.npz"), seed=1)
    cams = {1: colmap_model.Camera(1, "PINHOLE", 512, 512, K[[0, 1, 0, 1], [0, 1, 2, 2]])}
    images = {i + 1: colmap_model.Image(i + 1, np.array([1.0, 0, 0, 0]), np.zeros(3), 1, f"{i:04d}.png",
                                        np.zeros((0, 2)), np.zeros(0, np.int64)) for i in range(n)}
    colmap_model.write_model(cams, images, {}, os.path.join(sfm, "model"))  # names the DB views
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    records = demo.demo(cfg)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    det = [r for r in records if r["mode"] == "detect"]
    loftr_layers = 2 * 8  # both streams of LoFTR's 4 (self, cross) coarse layers
    expected = {k: 0 for k in counts} | {"K1_encoder_layer": 12 * n + loftr_layers * len(det),
                                         "K2_rowcol_stats": n + len(det), "K3_window_gather": n}
    log(f"[9e] demo, {n} frames of 512^2 (blank: {sorted(blank)}), {cfg.demo.num_ref_views} DB views, "
        f"min_track_inliers {cfg.demo.min_track_inliers}: {wall:.3f} s wall; modes "
        f"{''.join(r['mode'][0] for r in records)}, inliers {[r['inliers'] for r in records]}; launches {counts} "
        f"(expected {expected})")
    check(len(records) == n and counts == expected, "the demo did not run the kernels as its frames imply")
    for mode in ("detect", "track"):
        ms = [1e3 * r["seconds"] for r in records[1:] if r["mode"] == mode]
        stat = (f"median {np.median(ms):.2f} ms, p90 {np.percentile(ms, 90):.2f} ms over {len(ms)} frames"
                if ms else "no such frame after the first")
        log(f"[9e] {mode} frames (batch 1, synchronised, frame 0 apart): {stat}, on {smi}")
    log(f"[9e] frame 0 (detect, first calls' set-up included): {1e3 * records[0]['seconds']:.2f} ms")
    for mode in ("detect", "track"):
        seen = [i for i, r in enumerate(records) if r["mode"] == mode and i not in blank]
        r_err, t_err = _pose_errors([records[i]["pose"] for i in seen], poses[seen])
        log(f"[9e] {mode} frames that show the object ({len(seen)}) against GT: R err median "
            f"{np.median(r_err):.3f} deg (<= 5), t err median {np.median(t_err):.3f} cm (<= 5)")
        check(len(seen) > 0 and np.median(r_err) <= 5 and np.median(t_err) <= 5,
              f"the demo's {mode} poses miss the GT")
    check(all(np.isfinite(r["pose"]).all() for r in records), "non-finite demo pose")
    check(sorted(os.listdir(frames_dir)) == [f"{i:06d}.png" for i in range(n)] and os.path.getsize(video) > 0,
          "the demo's frames or video are missing")
    # where a frame's device time goes: the demo's batch-1 step (its
    # configuration, the same weights) on one full frame, under the profiler
    step = make_query_step(model, reproj_threshold_px=cfg.demo.pnp_reproj_thr,
                           num_hypotheses=cfg.demo.num_hypotheses)
    batch = {"query_image": torch.from_numpy(np.ascontiguousarray(frames[:1, ..., None])).cuda(),
             "intrinsics": torch.from_numpy(K[None].astype(np.float32)).cuda(), **cloud}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for _ in range(3):
        step(batch, gen, None)
    rows, busy, wall = device_rows(lambda: step(batch, gen, None))
    k1, k2, k3 = group_ms(rows, K1_NAMES), group_ms(rows, K2_NAMES), group_ms(rows, K3_NAMES)
    log(f"[9e] one batch-1 step under the profiler: wall {wall:.2f} ms, device time {busy:.2f} ms, idle share "
        f"{100 * (1 - busy / wall):.1f} % of that wall; K1 {k1:.2f} ms, K2 {k2:.2f} ms, K3 {k3:.3f} ms, "
        f"everything else {busy - k1 - k2 - k3:.2f} ms")
    for ms, count, key in rows[:15]:
        log(f"[9e]   {ms:9.3f} ms  x{count:<5d} {key[:100]}")
    k12 = [r for r in rows if _short(r[2]) in K1_NAMES + K2_NAMES]
    log(f"[9e] K1's and K2's launches in the frame: {launch_names(k12)}")
    check_f32_instances(rows, "9e")


# ----------------------------------------------------------------- phase 10

K6_NAMES = ("patch_gather_kernel",)


def phase10a(gen, smi: str) -> None:
    """K6 at the sparse fine FPN's shapes: the pin map [16, 256, 256, 196] bf16
    (392 bytes a pixel), K 512, W 9 (a 5x5 window and its 2-pixel halo), int64
    corners as ``fine_windows`` makes them, with invalid slots; and C = 130
    (260 bytes)."""
    n, h, w, k, win = B, 256, 256, 512, 9
    for c in (196, 130):
        f = torch.randn(n, h, w, c, generator=gen, device="cuda").to(torch.bfloat16)
        r0 = torch.randint(-win - 4, h + 4, (n, k), generator=gen, device="cuda")
        c0 = torch.randint(-win - 4, w + 4, (n, k), generator=gen, device="cuda")
        r0[:, -16:] = -10 * win  # invalid slots: all-zero patches
        k6_case("10a", f"bf16 C = {c}", f, r0, c0, win)
        del f
        torch.cuda.empty_cache()
    log(f"[10a] on {smi}")


def _sparse_models(dtype: str):
    base = OnePosePlusConfig(compute_dtype=dtype, coarse_matching=CoarseMatchingConfig(thr=0.0, max_matches=512))
    return {"dense": _model(base, "cuda"),
            "sparse": _model(dataclasses.replace(base, fine=dataclasses.replace(base.fine, sparse_fpn=True)), "cuda")}


def phase10b(frames, anno, smi: str) -> int:
    """The sparse query step at the bench shapes (16 frames of 512^2, 7000
    points, 512 slots, bf16, random weights) against the dense step on the same
    weights: the same match set, one K6 and no K3 launch a step, windows within
    one bf16 step, both steps' wall and device time; and the f32 forwards,
    where mkpts_query_f must agree within 1e-2 px (in bf16 one step of expec_f
    is already 2^-8 x 4 px = 0.0156 px there). Returns the sparse step's K6
    launches."""
    batch, gt, fwd = _step_batch(frames, anno)
    models = _sparse_models("bfloat16")
    outs = {}
    for name, model in models.items():
        with torch.no_grad():
            model(fwd)  # warm-up
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            outs[name] = {k: v for k, v in model(fwd).items() if torch.is_tensor(v)}
            torch.cuda.synchronize()
        counts = kernels.launch_counts()
        want = {"K1_encoder_layer": 12, "K2_rowcol_stats": 1, "K3_window_gather": int(name == "dense"),
                "K6_patch_gather": int(name == "sparse")}
        log(f"[10b] {name} bf16 forward launches: {counts}")
        check(all(counts[kk] == v for kk, v in want.items()), f"the {name} forward's launches are not {want}")
        if name == "sparse":
            sparse_k6 = counts["K6_patch_gather"]
    d, s = outs["dense"], outs["sparse"]
    same = all(torch.equal(d[k], s[k]) for k in ("i_ids", "j_ids", "match_mask"))
    m = d["match_mask"].bool()
    mk = (d["mkpts_query_f"].float() - s["mkpts_query_f"].float())[m].abs().amax(-1)
    ex_err = (d["expec_f"].float() - s["expec_f"].float())[m].abs().max().item()
    bb = models["sparse"].backbone  # the windows: convs on patches against the dense map's windows
    with torch.no_grad():
        _, ctx = bb.coarse_and_ctx(fwd["query_image"])
        win_s = bb.fine_windows(ctx, d["j_ids"], (64, 64), 4, 5).float()
        win_d = gather_windows_aligned(bb(fwd["query_image"])[1], d["j_ids"], (64, 64), 4, 5).float()
    w_err, scale = (win_s - win_d).abs(), win_d.abs().max().item()
    log(f"[10b] sparse vs dense bf16 forward, {B} frames: same slots and match set {same} ({int(m.sum())} "
        f"matches); windows max|d| {w_err.max().item():.3e} at scale {scale:.2f} (<= 2^-7 of it), "
        f"{100 * (w_err > 0).float().mean().item():.3f} % of window values differ; mkpts_query_f max|d| "
        f"{mk.max().item():.3e} px, median {mk.median().item():.3e}, {100 * (mk <= 1e-2).float().mean().item():.1f} % "
        f"within 1e-2 px; expec_f max|d| {ex_err:.3e}")
    check(same and w_err.max().item() <= 2 ** -7 * scale, "the sparse bf16 step does not reproduce the dense step")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for name in ("dense", "sparse", "sparse", "dense"):  # in turns
        step = make_query_step(models[name])
        wall = _step_wall(step, batch, gt)
        busy = device_rows(lambda: step(batch, gen, gt))[1]
        log(f"[10b] {name} bf16 query step: wall {wall:.2f} ms (median of 5), device {busy:.2f} ms "
            f"(torch.profiler, one step), on {smi}")
    del models, outs, win_s, win_d, w_err
    torch.cuda.empty_cache()
    with torch.no_grad():
        d, s = ({k: v for k, v in model(fwd).items() if torch.is_tensor(v)}
                for model in _sparse_models("float32").values())
    same = all(torch.equal(d[k], s[k]) for k in ("i_ids", "j_ids", "match_mask"))
    m = d["match_mask"].bool()
    mk_err = (d["mkpts_query_f"] - s["mkpts_query_f"])[m].abs().max().item()
    ex_err = (d["expec_f"] - s["expec_f"])[m].abs().max().item()
    log(f"[10b] sparse vs dense f32 forward, {B} frames: same slots and match set {same} ({int(m.sum())} "
        f"matches), mkpts_query_f max|d| {mk_err:.3e} px (<= 1e-2), expec_f max|d| {ex_err:.3e}")
    check(same and mk_err <= 1e-2, "the sparse f32 forward does not reproduce the dense forward")
    torch.cuda.empty_cache()
    return sparse_k6


def _conv_cases():
    """Quantized convs of the bench backbone at 512^2: (name, frames, cin, size,
    cout, kernel, stride, pad); the sparse FPN's first conv over 2048 patches."""
    return (("stem 7x7/2", B, 1, 512, 128, 7, 2, 3), ("layer1 3x3", 4, 128, 256, 128, 3, 1, 1),
            ("layer2.0 downsample 1x1/2", 4, 128, 256, 196, 1, 2, 0), ("layer2 3x3", 4, 196, 128, 196, 3, 1, 1),
            ("outconv2 valid 3x3 (sparse patches)", 2048, 196, 9, 196, 3, 1, 0))


def phase10c(frames, anno, smi: str) -> None:
    """The int8 backbone on the card: each quantized conv's int32 sums bitwise
    against the CPU on the same int8 operands (one frame) and its output equal
    to those sums times the scales; the 16-frame bf16 query step with
    quant_int8 against the float step (JAX's bounds on the backbone's maps, the
    match sets' Jaccard printed); the backbone int8 against bf16."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    for name, n, cin, size, cout, k, s, p in _conv_cases():
        x = torch.randn(n, cin, size, size, generator=gen, device="cuda").to(memory_format=torch.channels_last)
        wt = torch.randn(cout, cin, k, k, generator=gen, device="cuda") * 0.1
        xq, sx = quant.quantize_activation(x)
        wq, sw = quant.quantize_weight(wt)
        acc = quant.int8_conv_accumulate(xq, wq, s, p)
        out = quant.quant_conv(x, wt, s, p)
        acc_cpu = quant.int8_conv_accumulate(xq[:1].cpu(), wq.cpu(), s, p)
        torch.cuda.synchronize()
        eq_acc = torch.equal(acc[:1].cpu(), acc_cpu)
        eq_out = torch.equal(out[:1].cpu(), acc_cpu.float() * (sx * sw).cpu()[:, None, None])
        ms = time_ms(lambda: quant.quant_conv(x, wt, s, p), reps=5, warmup=1)
        log(f"[10c] int8 conv {name} [{n}, {cin}, {size}, {size}] -> {tuple(acc.shape)}: int32 sums of frame 0 "
            f"bitwise equal to the CPU's {eq_acc}, output = sums x scales {eq_out} (max|sum| "
            f"{acc.abs().max().item()}), whole call {ms:.3f} ms")
        check(eq_acc and eq_out, f"int8 conv {name} differs from the CPU")
        del x, xq, acc, out
    torch.cuda.empty_cache()
    base = OnePosePlusConfig(compute_dtype="bfloat16", coarse_matching=CoarseMatchingConfig(thr=0.0, max_matches=512))
    qcfg = dataclasses.replace(base, backbone=dataclasses.replace(base.backbone, quant_int8=True))
    models = {"bf16": _model(base, "cuda"), "int8": _model(qcfg, "cuda")}
    _, _, fwd = _step_batch(frames, anno)
    img = fwd["query_image"]
    maps, outs, times = {}, {}, {}
    with torch.no_grad():
        for name, model in models.items():
            maps[name] = [t.double().flatten() for t in model.backbone(img)]
            outs[name] = model(fwd)
            times[name] = time_ms(lambda: model.backbone(img), reps=10, warmup=2)
    for level, tag in enumerate(("coarse", "fine")):
        g, w_ = maps["int8"][level], maps["bf16"][level]
        cos = (g @ w_ / (g.norm() * w_.norm())).item()
        rel = ((g - w_).norm() / w_.norm()).item()
        log(f"[10c] int8 backbone vs bf16, {tag} map: cosine {cos:.5f} (> 0.995), relative error {rel:.4f} (< 0.12)")
        check(cos > 0.995 and rel < 0.12, f"the int8 backbone's {tag} map misses JAX's bounds")
    jacc = []
    for f in range(B):
        sets = [set(zip(o["i_ids"][f][o["match_mask"][f]].tolist(), o["j_ids"][f][o["match_mask"][f]].tolist()))
                for o in (outs["int8"], outs["bf16"])]
        jacc.append(len(sets[0] & sets[1]) / max(len(sets[0] | sets[1]), 1))
    check(all(bool(torch.isfinite(outs["int8"][k].float()).all()) for k in ("mkpts_query_f", "mconf")),
          "non-finite outputs of the int8 step")
    log(f"[10c] int8 step vs bf16 step, {B} frames: match-set Jaccard median {np.median(jacc):.3f}, min "
        f"{min(jacc):.3f}; matches {int(outs['int8']['match_mask'].sum())} vs {int(outs['bf16']['match_mask'].sum())}")
    log(f"[10c] backbone [{B}, 512, 512]: int8 {times['int8']:.2f} ms, bf16 {times['bf16']:.2f} ms "
        f"(CUDA-event medians of 10), on {smi}")
    del models
    torch.cuda.empty_cache()


def phase10d() -> None:
    """The other backbones and the LayerNorm keypoint encoder, one f32 forward
    each on the card against the CPU (TF32 off): ResNetFPN_16_4 at its default
    widths, ResNet18_C at stages 2 and 3 with both block types."""
    rng = np.random.default_rng(11)
    img = torch.from_numpy(_textured_images(rng, 2, 256)[..., None])
    cases = [("ResNetFPN_16_4", ResNetFPNConfig(block_dims=(128, 196, 256, 512))),
             ("ResNetFPN_16_4", ResNetFPNConfig(block_dims=(128, 196, 256, 512), block_type="bottleneck"))]
    cases += [(f"ResNet18C{s}", ResNetFPNConfig(block_type=bt)) for s in (2, 3) for bt in ("basic", "bottleneck")]
    for name, cfg in cases:
        outs = {}
        for dev in ("cuda", "cpu"):
            model = build_backbone(name, cfg)
            model.load_state_dict(random_state_dict(model, seed=3))
            model.eval().to(dev)
            with torch.no_grad():
                out = model(img.to(dev))
            outs[dev] = [t.cpu() for t in (out if isinstance(out, tuple) else (out,))]
        errs = [((g - c).abs().max() / c.abs().max()).item() for g, c in zip(outs["cuda"], outs["cpu"])]
        log(f"[10d] {name} ({cfg.block_type}, {cfg.block_dims}) on {tuple(img.shape)}: outputs "
            f"{[tuple(t.shape) for t in outs['cuda']]}, max|d| / max {max(errs):.2e} (<= 1e-4)")
        check(max(errs) <= 1e-4, f"{name} on the card differs from the CPU")
    kp = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, 7000, 3)).astype(np.float32))
    desc = torch.from_numpy(rng.standard_normal((2, 7000, 256)).astype(np.float32))
    outs = {}
    for dev in ("cuda", "cpu"):
        enc = KeypointEncoder(norm_method="layernorm")
        enc.load_state_dict(random_state_dict(enc, seed=4))
        with torch.no_grad():
            outs[dev] = enc.to(dev)(kp.to(dev), desc.to(dev)).cpu()
    err = (outs["cuda"] - outs["cpu"]).abs().max().item()
    log(f"[10d] LayerNorm keypoint encoder [2, 7000, 3] -> {tuple(outs['cuda'].shape)}: max|d| {err:.2e} (<= 1e-4)")
    check(err <= 1e-4, "the LayerNorm keypoint encoder on the card differs from the CPU")


# ----------------------------------------------------------------- phase 11


def _arkit_capture(seq_dir: str, angles_deg, seed: int, size=(640, 480), fx: float = 600.0) -> None:
    """A synthetic ARKit capture as the iOS app records one and
    parse_scanned_data reads it: Frames.m4v (mp4v), Frames.txt (per-frame
    intrinsics), ARposes.txt (camera to world in ARKit's axes: y up, the
    camera looking down -z) and Box.txt (the object box at the world origin,
    0.3 x 0.3 x 0.1 m). The object is a textured plane (z = 0, 0.5 m wide)
    rendered in each frame through its plane-induced homography, seen from
    0.6 m by a camera orbiting it at ``angles_deg`` about the vertical axis."""
    import cv2
    from scipy.spatial.transform import Rotation

    os.makedirs(seq_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    w, h = size
    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1.0]])
    tex = (np.kron(rng.random((32, 32)), np.ones((16, 16))) * 255).astype(np.uint8)
    S = np.array([[512 / 0.5, 0, 256], [0, 512 / 0.5, 256], [0, 0, 1.0]])  # plane metres -> texture pixels
    flip = np.diag([1.0, -1.0, -1.0])  # OpenCV camera axes <-> ARKit's
    video = cv2.VideoWriter(os.path.join(seq_dir, "Frames.m4v"), cv2.VideoWriter_fourcc(*"mp4v"), 10, (w, h))
    poses, intrinsics = [], []
    for i, a in enumerate(np.deg2rad(np.asarray(angles_deg, np.float64))):
        center = 0.6 * np.array([np.sin(a), 0.05 * np.sin(3 * a), -np.cos(a)])
        z = -center / np.linalg.norm(center)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])  # object (= world) -> camera, OpenCV axes
        H = K @ np.stack([R[:, 0], R[:, 1], -R @ center], axis=1) @ np.linalg.inv(S)
        video.write(cv2.cvtColor(cv2.warpPerspective(tex, H, (w, h)), cv2.COLOR_GRAY2BGR))
        qx, qy, qz, qw = Rotation.from_matrix(R.T @ flip).as_quat()  # camera -> world, ARKit axes
        poses.append(f"{i / 10},{center[0]},{center[1]},{center[2]},{qw},{qx},{qy},{qz}\n")
        intrinsics.append(f"{i},{i / 10},{fx},{fx},{w / 2},{h / 2}\n")
    video.release()
    with open(os.path.join(seq_dir, "ARposes.txt"), "w") as f:
        f.writelines(poses)
    with open(os.path.join(seq_dir, "Frames.txt"), "w") as f:
        f.writelines(intrinsics)
    with open(os.path.join(seq_dir, "Box.txt"), "w") as f:
        f.write("# px,py,pz,ex,ey,ez,qw,qx,qy,qz\n0,0,0,0.3,0.3,0.1,1,0,0,0\n")


def _write_plane_object(root: str, obj: str, n_frames: int, img: int, seed: int) -> None:
    """Phase 8c's object (``_plane_object``) in the OnePose layout the SfM and
    evaluation CLIs read: ``color/``, ``intrin_ba/``, ``poses_ba/`` and
    ``box3d_corners.txt``."""
    import cv2

    images, Ks, poses, corners = _plane_object(n_frames, img, seed)
    seq = os.path.join(root, obj, obj.split("-", 1)[1] + "-1")
    for sub in ("color", "intrin_ba", "poses_ba"):
        os.makedirs(os.path.join(seq, sub), exist_ok=True)
    for i, frame in images.items():
        cv2.imwrite(os.path.join(seq, "color", f"{i:04d}.png"), np.round(frame * 255).astype(np.uint8))
        np.savetxt(os.path.join(seq, "intrin_ba", f"{i:04d}.txt"), Ks[i])
        np.savetxt(os.path.join(seq, "poses_ba", f"{i:04d}.txt"), poses[i])
    np.savetxt(os.path.join(root, obj, "box3d_corners.txt"), corners)


class _Tee(io.TextIOBase):
    """Writes to stdout and keeps a copy (a CLI's own lines)."""

    def __init__(self):
        self.kept = io.StringIO()

    def write(self, s):
        sys.__stdout__.write(s)
        return self.kept.write(s)

    def flush(self):
        sys.__stdout__.flush()


def _cli_stage(main_fn, argv, walls, peaks, counts, name: str) -> str:
    """One CLI's ``main(argv)``: its launches counted from 0, its wall
    (synchronised) and peak device memory (the counter reset before it).
    Returns what the CLI printed."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    tee = _Tee()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        main_fn(argv)
    torch.cuda.synchronize()
    walls[name] = time.perf_counter() - t0
    peaks[name] = torch.cuda.max_memory_allocated() / 2 ** 30
    counts[name] = kernels.launch_counts()
    return tee.kept.getvalue()


def _check_hloc_exports(root: Path, names: dict) -> int:
    """Both h5 files, read with the port's reader, hold raw_matches.pkl's
    matches: per image the raw end points rounded to pixels (merged) with their
    summed confidences, per pair one index match per distinct rounded raw
    match with its largest confidence. Returns the number of pairs."""
    import pickle

    from onepose_plus_plus_tpu_torch.data.image_io import grouped_load_h5

    with open(root / "raw_matches.pkl", "rb") as f:
        raw = pickle.load(f)["raw"]
    feats, matches = grouped_load_h5(str(root / "feats-loftr.h5")), grouped_load_h5(str(root / "matches-loftr.h5"))
    ends = {}
    for pm in raw:
        for img, pts in zip(pm.pair, (pm.pts0, pm.pts1)):
            for p, c in zip(map(tuple, np.round(pts)), pm.conf):
                ends[img, p] = ends.get((img, p), 0.0) + c
    check(set(feats) == {names[i] for i, _ in ends}, "feats-loftr.h5 holds other images than raw_matches.pkl")
    for i, name in names.items():
        if name not in feats:
            continue
        f = feats[name]
        kp = {tuple(p): s for p, s in zip(f["keypoints"].astype(np.float64), f["scores"])}
        check(kp.keys() == {p for j, p in ends if j == i} and len(kp) == len(f["keypoints"])
              and np.allclose([kp[p] for p in kp], [ends[i, p] for p in kp], rtol=1e-6)
              and f["descriptors"].shape == (256, len(kp)) and not f["descriptors"].any(),
              f"feats-loftr.h5's {name} differs from raw_matches.pkl")
    check(set(matches) == {f"{names[i]}_{names[j]}" for i, j in (pm.pair for pm in raw)},
          "matches-loftr.h5 holds other pairs than raw_matches.pkl")
    for pm in raw:
        (i, j), m = pm.pair, matches[f"{names[pm.pair[0]]}_{names[pm.pair[1]]}"]
        got = np.c_[feats[names[i]]["keypoints"][m["matches"][:, 0]], feats[names[j]]["keypoints"][m["matches"][:, 1]]]
        best = {}
        for row, c in zip(map(tuple, np.c_[np.round(pm.pts0), np.round(pm.pts1)]), pm.conf):
            best[row] = max(best.get(row, -1.0), c)
        rows = [tuple(r) for r in got.astype(np.float64)]
        check(m["matches"].dtype == np.int64 and len(rows) == len(best) and set(rows) == set(best)
              and np.allclose(m["matching_scores"], [best[r] for r in rows], rtol=1e-6),
              f"matches-loftr.h5's pair {pm.pair} differs from raw_matches.pkl")
    return len(raw)


def _sfm_files(root: Path, gallery: int) -> list:
    files = ["raw_matches.pkl", "feats-loftr.h5", "matches-loftr.h5", "stats.json", "model/cameras.bin",
             "model/images.bin", "model/points3D.bin", "anno/anno_3d_average.npz",
             "anno/anno_3d_average_coarse.npz", "anno/anno_2d.json", "vis3d/point_cloud_pre_filter.ply",
             "vis3d/point_cloud_post_filter.ply"]
    missing = [f for f in files if not (root / f).is_file()]
    pngs = sorted((root / "vis3d" / "matches").glob("*.png")) if gallery else []
    check(not missing and len(pngs) == gallery, f"the SfM's files in {root}: missing {missing}, "
          f"{len(pngs)} gallery PNGs (expected {gallery})")
    return files + [f"vis3d/matches/{p.name}" for p in pngs]


def _counted_surfaces(calls: dict):
    """``make_loftr_fns`` whose three surfaces count their calls in ``calls``
    (the SfM CLI's matcher calls, from which its launches follow)."""
    def make(matcher):
        return tuple(_counted(fn, calls, name)
                     for fn, name in zip(make_loftr_fns(matcher), ("coarse", "refine", "extract")))
    return make


def _sfm_stage(argv, root_of, walls, peaks, counts, name: str, gallery: int, names_of, smi: str) -> dict:
    """The SfM CLI through ``main(argv)`` on the card, its matcher surfaces
    counted: the launches against its calls, its files, its h5 exports
    against raw_matches.pkl, its model statistics."""
    from onepose_plus_plus_tpu_torch.sfm import cli as sfm_cli

    calls = {"coarse": 0, "refine": 0, "extract": 0}
    sfm_cli.make_loftr_fns = _counted_surfaces(calls)
    try:
        out = _cli_stage(sfm_cli.main, argv, walls, peaks, counts, name)
    finally:
        sfm_cli.make_loftr_fns = make_loftr_fns
    check("mapping 1 object(s) on cuda" in out, f"[{name}] the SfM CLI did not map one object on cuda")
    root = root_of()
    files = _sfm_files(root, gallery)
    n_pairs = _check_hloc_exports(root, names_of())
    stats = json.loads((root / "stats.json").read_text())
    _, model_images, _ = colmap_model.read_model(str(root / "model"))
    per_forward = 16  # both streams of LoFTR's 4 (self, cross) coarse layers
    expected = {k: 0 for k in counts[name]} | {
        "K1_encoder_layer": per_forward * sum(calls.values()), "K2_rowcol_stats": calls["coarse"],
        "K6_patch_gather": 2 * calls["refine"]}
    log(f"[{name}] {walls[name]:.3f} s wall, peak {peaks[name]:.2f} GiB; matcher calls {calls} ({n_pairs} pairs in "
        f"batches of 8, {len(model_images)} images in batches of 8); launches {counts[name]} (expected {expected}); "
        f"{stats['num_points3D']} points, {stats['num_reg_images']} registered frames, mean track length "
        f"{stats['mean_track_length']:.3f}; h5 exports read back equal to raw_matches.pkl; files {files}; on {smi}")
    check(counts[name] == expected and calls["coarse"] == -(-n_pairs // 8) and calls["refine"] > 0
          and calls["extract"] == -(-len(model_images) // 8),
          f"[{name}] the SfM CLI did not run the kernels as its matcher calls imply")
    check(stats["num_points3D"] > 0 and stats["num_reg_images"] >= 2, f"[{name}] the SfM registered too little")
    return stats


def phase11(tmp: str, smi: str) -> None:
    """The user's CLI chains on the card through each CLI's own ``main(argv)``
    with the shipped configs at full width, random weights (each CLI draws
    its own, seed 666), no ``device=`` argument (each CLI's default: cuda).
    11a the demo pipeline as scripts/torch_demo_pipeline.sh runs it: a
    synthetic ARKit capture (50 annotate frames and 20 test frames of 640x480
    of a textured plane) -> parse_scanned_data -> sfm +preprocess=sfm_demo
    (every 5th frame: 10) -> demo +experiment=inference_demo (its frames and
    video written under the phase's directory). 11b the evaluation chain on
    phase 8c's object (20 frames of 512^2): sfm +preprocess=sfm_inference_onepose
    (all 20 frames, its 6-pair match gallery and 4096 keypoint slots) ->
    inference +experiment=inference_onepose on that SfM's annotation -> merge
    +preprocess=merge_anno. Both SfM runs lower model.match_coarse.thr to
    1e-6, as 8c does: random weights find no match at the shipped threshold.
    Poses are not scored (random LoFTR descriptors against a random 2D-3D
    matcher); 9d and 9e hold poses to GT."""
    from onepose_plus_plus_tpu_torch import merge, parse_scanned_data
    from onepose_plus_plus_tpu_torch.sfm import cli as sfm_cli

    torch.backends.cudnn.benchmark = False  # as a fresh CLI process
    walls, peaks, counts = {}, {}, {}
    thr = "model.match_coarse.thr=0.000001"

    # 11a: the demo pipeline
    data, obj = Path(tmp, "demo"), "0001-plane"
    t0 = time.perf_counter()
    _arkit_capture(str(data / obj / "plane-annotate"), np.linspace(-40, 40, 50), seed=110)
    _arkit_capture(str(data / obj / "plane-test"), np.linspace(-30, 30, 20), seed=110)
    log(f"[11a] synthetic capture: 50 + 20 frames of 640x480 (mp4v) in {time.perf_counter() - t0:.3f} s, "
        f"on {smi}")
    _cli_stage(parse_scanned_data.main, ["--scanned_object_path", str(data / obj)], walls, peaks, counts, "11a parse")
    n_test = len(os.listdir(data / obj / "plane-test" / "color"))
    check(len(os.listdir(data / obj / "plane-annotate" / "color")) == 50 and n_test == 20,
          "parse_scanned_data did not write every frame")
    log(f"[11a parse] {walls['11a parse']:.3f} s wall, 50 + 20 frames cropped to 512^2, on {smi}")
    sfm = data / "sfm_model"
    annotate = sfm_cli.load_sequence(str(data / obj / "plane-annotate"))[0][::5]  # sfm_demo: down_ratio 5
    _sfm_stage(["+preprocess=sfm_demo", f"dataset.data_dir={data}", f"dataset.outputs_dir={sfm}", thr],
               lambda: sfm / obj, walls, peaks, counts, "11a sfm (sfm_demo)", 0,
               lambda: {i: os.path.basename(p) for i, p in enumerate(annotate)}, smi)
    frames, video = Path(tmp, "demo_frames"), Path(tmp, "demo.mp4")
    out = _cli_stage(demo.main, ["+experiment=inference_demo", f"dataset.data_dir={data}",
                                 f"dataset.sfm_outputs_dir={sfm}", f"demo.frames_dir={frames}",
                                 f"demo.output_video={video}"], walls, peaks, counts, "11a demo")
    c = counts["11a demo"]
    detects = c["K2_rowcol_stats"] - n_test  # one match_coarse over the DB views a detect frame
    expected = {k: 0 for k in c} | {"K1_encoder_layer": 12 * n_test + 16 * detects,
                                    "K2_rowcol_stats": n_test + detects, "K3_window_gather": n_test}
    log(f"[11a demo] {walls['11a demo']:.3f} s wall, peak {peaks['11a demo']:.2f} GiB; {n_test} frames, {detects} "
        f"detect frames; launches {c} (expected {expected}: 12 K1 and one K2, K3 a frame, 16 K1 and one K2 a "
        f"detection); {len(os.listdir(frames))} frames and {video.stat().st_size if video.exists() else 0} bytes "
        f"of video; on {smi}")
    check(f"demo: {obj} on cuda" in out, "the demo did not run on cuda")
    check(c == expected and 1 <= detects <= n_test, "the demo did not run the kernels as its frames imply")
    check(sorted(os.listdir(frames)) == [f"{i:06d}.png" for i in range(n_test)] and video.stat().st_size > 0,
          "the demo's frames or video are missing")

    # 11b: SfM -> evaluation -> merge on 8c's object
    data, obj = Path(tmp, "objects"), "0001-plane"
    _write_plane_object(str(data), obj, 20, 512, seed=82)
    sfm, results = Path(tmp, "sfm_outputs"), Path(tmp, "results")
    _sfm_stage(["+preprocess=sfm_inference_onepose", "ids=null", f"dataset.data_dir={data}",
                f"dataset.outputs_dir={sfm}", "dataset.down_ratio=1", thr],
               lambda: sfm / obj, walls, peaks, counts, "11b sfm (sfm_inference_onepose)", 6,
               lambda: {i: f"{i:04d}.png" for i in range(20)}, smi)
    out = _cli_stage(inference_cli.main, ["+experiment=inference_onepose", "ids=null", f"dataset.data_dir={data}",
                                          f"dataset.sfm_outputs_dir={sfm}", f"output_dir={results}"],
                     walls, peaks, counts, "11b inference")
    c, steps = counts["11b inference"], -(-20 // 16)  # frame_batch 16
    expected = {k: 0 for k in c} | {"K1_encoder_layer": 12 * steps, "K2_rowcol_stats": steps,
                                    "K3_window_gather": steps}
    errors = json.loads((results / f"errors_{obj}.json").read_text())
    metrics = (results / "metrics.txt").read_text().splitlines()
    log(f"[11b inference] {walls['11b inference']:.3f} s wall, peak {peaks['11b inference']:.2f} GiB; launches {c} "
        f"(expected {expected} for {steps} steps of 16 frames); files {sorted(os.listdir(results))}, "
        f"{len(errors['frames'])} frames; on {smi}")
    check("evaluating 1 object(s) on cuda" in out, "the evaluation CLI did not run on cuda")
    check(c == expected, "the evaluation CLI did not run the kernels as its steps imply")
    check(len(errors["frames"]) == 20 and metrics[-1].startswith("ALL: {")
          and all(np.isfinite(errors["R_errs_deg"])) and all(np.isfinite(errors["t_errs_cm"])),
          "the evaluation CLI's files are incomplete")
    merged = Path(tmp, "train_anno.json")
    _cli_stage(merge.main, ["+preprocess=merge_anno", f"dataset.sfm_outputs_dir={sfm}",
                            f"dataset.out_train_file={merged}", "dataset.out_val_file=null"],
               walls, peaks, counts, "11b merge")
    blob = json.loads(merged.read_text())
    n_anno2d = len(json.loads((sfm / obj / "anno" / "anno_2d.json").read_text()))
    log(f"[11b merge] {walls['11b merge']:.3f} s wall; {len(blob['images'])} images, {len(blob['annotations'])} "
        f"annotations (anno_2d.json: {n_anno2d}); on {smi}")
    check(len(blob["images"]) == len(blob["annotations"]) == n_anno2d > 0
          and not any(counts["11b merge"].values()), "the merged COCO file does not hold the SfM's annotation")
    log("[11] stage walls (s, synchronised): " + ", ".join(f"{k} {v:.3f}" for k, v in walls.items())
        + f"; total {sum(walls.values()):.3f}; on {smi}")
    log("[11] peak device memory by stage (GiB, the counter reset before each): "
        + ", ".join(f"{k} {v:.2f}" for k, v in peaks.items()) + f"; on {smi}")


K4_NAMES = ("scatter_index_kernel", "window_sum_kernel")
# K5 on the tensor cores: the operand pack, K2's LSE pass, the loss, g sums and feature gradients
K5_NAMES = ("pack_operand_kernel", "lse_tc_kernel", "col_lse_reduce", "loss_tc_kernel", "gsum_tc_kernel",
            "colg_reduce", "dfeat_tc_kernel")
K5_OLD_NAMES = ("lse_kernel", "loss_kernel", "gsum_kernel", "df0_kernel", "df1_kernel")  # the CUDA-core design


# phases that need nothing another phase makes: ``python3 chip_smoke.py <name> ...`` runs them alone
STANDALONE = {"8m": phase8m}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    unknown = sorted(set(argv) - set(STANDALONE))
    if unknown:
        raise SystemExit(f"no standalone phase {unknown}; those there are: {sorted(STANDALONE)}")
    smi = phase0()
    phase1(smi)
    no_tf32()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    if argv:
        for name in argv:
            STANDALONE[name](gen, smi)
        print(json.dumps({"ok": True, "phases": argv, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}}))
        return 0
    records = {"K1_encoder_layer": phase2_k1(gen), "K2_rowcol_stats": phase2_k2(gen),
               "K3_window_gather": phase2_k3(gen)}
    phase2_k2_wide(gen, smi)  # K2 above 576 channels
    phase2_narrow(gen, smi)  # K3, K4, K6 at pixels of any width
    torch.cuda.empty_cache()
    # K6 at the SfM shapes here, early: 8a profiles every call, and late in
    # this long process torch.profiler has returned sessions without device events
    records["K6_patch_gather"] = phase8a(gen)
    torch.cuda.empty_cache()
    phase2_f32(gen)
    # K7's kernel checks run here, early: late in this long process torch.profiler
    # has returned sessions without device events, and 9a checks kernel names
    records["K7_short_encoder"] = phase9a(gen)
    torch.cuda.empty_cache()
    phase3()
    phase4()
    counts, model, frames, anno, res5 = phase5(smi)
    # the mesh path at world 1; it releases its process group before 7e and 11 make theirs
    for name, n in phase5m(model, frames, anno, res5, smi).items():
        counts[name] += n
    phase6(model, frames, anno, smi)
    del model
    torch.cuda.empty_cache()
    # the off-by-default options (slice 10); early, where torch.profiler keeps its device events
    phase10a(gen, smi)
    sparse_k6 = phase10b(frames, anno, smi)  # the sparse query step's own run
    phase10c(frames, anno, smi)
    phase10d()
    torch.cuda.empty_cache()
    records["K4_window_scatter"] = phase7a(gen)
    records["K5_coarse_loss"] = phase7b(gen)
    torch.cuda.empty_cache()
    phase7f(gen, smi)  # K5 at the coarse widths above 256
    torch.cuda.empty_cache()
    phase7c()
    phase7c(512)  # a train config with a 512-channel coarse stage: K5 in two chunks
    phase7c(1024)  # a 1024-channel coarse stage: K2's wide_tf32, K5's wide instance
    train_counts, step_ms = phase7d(smi)  # K1-K3 keep their inference counts (phase 5)
    counts.update({k: v for k, v in train_counts.items() if k.startswith(("K4", "K5"))})
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        phase7e(tmp, step_ms, smi)
    torch.cuda.empty_cache()
    phase8b()
    sfm_counts = phase8c(smi)  # the SfM path's own run: K6's launches come from it
    counts["K6_patch_gather"] = sfm_counts["K6_patch_gather"] + sparse_k6
    torch.cuda.empty_cache()
    phase8m(gen, smi)  # LoFTR outdoor's padded path at MegaDepth-1500 shapes
    torch.cuda.empty_cache()
    phase8d()
    torch.cuda.empty_cache()
    phase8e(smi)
    counts["K7_short_encoder"] = phase9b(gen, smi)  # K7's harness: the fine transformer
    torch.cuda.empty_cache()
    # the CLIs as a fresh process runs them: PyTorch's default TF32 settings
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    phase9c(smi)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        phase9d(tmp, smi)
        torch.cuda.empty_cache()
        phase9e(tmp, smi)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        phase11(tmp, smi)  # the user's CLI chains
    check("jax" not in sys.modules, "the port loaded JAX")
    reference = kernels.__name__.split(".")[0].removesuffix("_torch")  # the JAX package
    check(not any(m.split(".")[0] == reference for m in sys.modules), "the port loaded the JAX package")
    kernel_lines = [
        {"name": name, "route": "cuda", **meta, "launches": counts[name], **records[name]}
        for name, meta in KERNELS.items()
    ]
    offsets = PROFILER["offsets"] or [(0.0, float("nan"))]
    log(f"[profiler] {PROFILER['sessions']} sessions, {PROFILER['again']} profiled again for want of device "
        f"events; least kernel start less its launch's: {offsets[0][1]:.3f} ms at {offsets[0][0]:.0f} s, "
        f"{offsets[-1][1]:.3f} ms at {offsets[-1][0]:.0f} s, range {min(o for _, o in offsets):.3f} to "
        f"{max(o for _, o in offsets):.3f} ms over {len(PROFILER['offsets'])} sessions, "
        f"{sum(abs(o) > 1 for _, o in offsets)} of them more than 1 ms either way")
    log(smi)
    print(json.dumps({"kernels": kernel_lines}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
