#!/usr/bin/env python3
"""Time ``run_inference`` of one checkout of the port at ``chip_smoke.py``
phase 5's configuration, for A/B runs on one card.

    python3 scripts/torch_query_ab.py [--tree DIR] [--reps 5] [--no-mesh]    # needs one CUDA GPU and nvcc

Imports ``chip_smoke`` (and through it ``onepose_plus_plus_tpu_torch``) from
DIR (default: the checkout this script lies in), builds its kernels there, and
runs phase 5's inputs: the default model in bf16 with random weights (seed 0),
48 frames of 512^2, a 7000-point cloud, 512 match slots, ``frame_batch`` 16.
After a warm-up, ``--reps`` runs, each a synchronised wall, then one run under
torch.profiler for its device time and its kernels' device time by name.
Where the tree's ``run_inference`` takes ``mesh=`` (and ``--no-mesh`` is not
given), each rep also runs it over ``make_mesh("cuda", 0, 1)`` (NCCL,
world 1) in turns with the run without a mesh (which goes first alternates),
every mesh result is held bitwise to the run without a mesh, and the mesh
run's one gather is timed. Prints one JSON line last: the walls (s), poses/s
at the median wall, the device time (ms) of one run and a digest of the
results, so that two trees' results can be compared bitwise. Only entry
points that every checkout of the port has are called, so that two trees (an
older commit unpacked beside this one) can be run in turns on one card:
parent, change, change, parent.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import sys
import time
from pathlib import Path


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent))
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--no-mesh", action="store_true", help="run without a mesh only, as a tree without one")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import chip_smoke as cs
    import numpy as np
    import torch
    from onepose_plus_plus_tpu_torch.inference import pipeline
    from onepose_plus_plus_tpu_torch.parallel.mesh import make_mesh, release_mesh

    smi = cs.phase0()
    cs.no_tf32()
    rng = np.random.default_rng(5)  # phase 5's inputs, drawn in its order
    n_frames = 48
    K, pts, Ts = cs._scene(rng, n_frames, 7000)
    imgs = (cs._textured_images(rng, n_frames) * 255).astype(np.uint8)
    frames = [{"image": imgs[i], "K": K.astype(np.float32), "pose_gt": Ts[i].astype(np.float32)}
              for i in range(n_frames)]
    anno = {"keypoints3d": pts.astype(np.float32),
            "descriptors3d": rng.standard_normal((7000, 128)).astype(np.float32),
            "descriptors3d_coarse": rng.standard_normal((7000, 256)).astype(np.float32)}
    cfg = cs.OnePosePlusConfig(compute_dtype="bfloat16",
                               coarse_matching=cs.CoarseMatchingConfig(thr=0.0, max_matches=512))
    model = cs._model(cfg, "cuda")

    def run(fs, **kw):
        return pipeline.run_inference(model, fs, anno, shape3d=7000, frame_batch=16, **kw)

    has_mesh = "mesh" in inspect.signature(pipeline.run_inference).parameters and not args.no_mesh
    m = make_mesh("cuda", 0, 1) if has_mesh else None
    gather_walls = []
    if m is not None:
        gather = pipeline._gather_frames

        def timed_gather(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = gather(*a)
            gather_walls.append(time.perf_counter() - t0)
            return out

        pipeline._gather_frames = timed_gather
    t0 = time.perf_counter()
    run(frames[:16])
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    if m is not None:
        run(frames[:16], mesh=m)  # NCCL's first call
    walls, mesh_walls, ref = [], [], None
    for i in range(args.reps):
        for mesh in ((None, m) if i % 2 == 0 else (m, None)) if m is not None else (None,):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run(frames, **({"mesh": mesh} if mesh is not None else {}))
            torch.cuda.synchronize()
            (walls if mesh is None else mesh_walls).append(time.perf_counter() - t0)
            got = [np.asarray(getattr(res, k)) for k in ("poses", "num_inliers", "ok", "num_matches",
                                                         "R_errs", "t_errs")]
            ref = ref or got
            cs.check(all(np.array_equal(a, b) for a, b in zip(got, ref)), "the runs' results differ")
    rows, busy, _ = cs.device_rows(lambda: run(frames))
    if m is not None:
        release_mesh()
    digest = hashlib.sha256(b"".join(np.ascontiguousarray(a).tobytes() for a in ref)).hexdigest()[:16]
    out = {"tree": args.tree, "device": smi, "first_call_s": first, "walls_s": walls,
           "poses_per_s": n_frames / float(np.median(walls)), "device_ms": busy, "results_sha256": digest,
           "ok": int(ref[2].sum()), "median_matches": float(np.median(ref[3])),
           "kernels_ms": [[round(ms, 4), n, name[:90]] for ms, n, name in rows[:25]]}
    if m is not None:
        out.update(mesh_walls_s=mesh_walls, mesh_poses_per_s=n_frames / float(np.median(mesh_walls)),
                   gather_ms=[1e3 * w for w in gather_walls[1:]], first_gather_ms=1e3 * gather_walls[0])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
