"""One-line throughput record: ``python -m onepose_plus_plus_tpu_torch.bench``.

Port of the repository's ``bench.py``: the complete query step
(``inference.pipeline.make_query_step``: the matcher forward with kernels
K1-K3, RANSAC-PnP with 512 hypotheses, the pose errors against GT identity
poses) at the reference's inference shapes, 48 frames of 512² a step, a
7000-point cloud, 512 match slots, bf16 compute, random weights (numpy seed
0). One warm-up step, then 32 timed steps on a synchronised host clock, each
step's input perturbed by its index and every output copied back to the host.
Prints ONE JSON line: ``{"metric", "value", "unit", "vs_baseline"}``.

``main()`` takes the shapes and the device as arguments (the defaults are the
command line's), so that a test can run it small on the CPU, and ``model_cfg``,
a ``model`` block in the YAML key names of ``models/build.py`` over the bench's
own (bf16). The command line takes the same overrides as the evaluation CLI,
e.g. ``python -m onepose_plus_plus_tpu_torch.bench model.loftr_fine.sparse_fpn=true
model.loftr_backbone.quant_int8=true``.
"""
from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .inference.cli import CONFIGS_DIR
from .inference.pipeline import make_query_step
from .models.build import onepose_config_from_dict
from .models.onepose_plus import OnePosePlusModel
from .utils.config_loader import load_config
from .utils.weights import random_state_dict

# The denominator of vs_baseline, as in the repository's bench.py: the derived
# upper bound of the unmodified reference (PyTorch forward + pycolmap RANSAC,
# one frame at a time) on an RTX 3090, from scripts/derive_reference_fps.py
# (artifacts/reference_fps.json). It is a GPU bound of the reference, not a
# TPU number, and not a measurement of this port.
REFERENCE_FPS = 41.0


def main(batch: int = 48, img: int = 512, n_points: int = 7000, steps: int = 32,
         device: str = "cuda", model_cfg: Optional[Dict[str, Any]] = None) -> dict:
    """Time the query step; print and return the JSON record."""
    rng = np.random.default_rng(0)
    inputs = {
        "query_image": rng.random((batch, img, img, 1), np.float32),
        "keypoints3d": rng.standard_normal((batch, n_points, 3)).astype(np.float32),
        "descriptors3d": rng.standard_normal((batch, n_points, 128)).astype(np.float32),
        "descriptors3d_coarse": rng.standard_normal((batch, n_points, 256)).astype(np.float32),
        "intrinsics": np.tile(np.eye(3, dtype=np.float32) * 500.0, (batch, 1, 1)),
    }
    inputs = {k: torch.from_numpy(v).to(device) for k, v in inputs.items()}
    model = OnePosePlusModel(onepose_config_from_dict({"compute_dtype": "bfloat16", **(model_cfg or {})}))
    model.load_state_dict(random_state_dict(model, seed=0))
    model.eval().to(device)
    step = make_query_step(model, num_hypotheses=512)
    pose_gt = torch.eye(4, device=device).repeat(batch, 1, 1)
    generator = torch.Generator(device=device)
    generator.manual_seed(0)
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)

    def run(i: int):
        # the step index moves every pixel (1e-6 is above f32's resolution at
        # the image's values, where bench.py's 1e-9 is below it)
        b = dict(inputs, query_image=inputs["query_image"] + i * 1e-6)
        return [out.cpu() for out in step(b, generator, pose_gt)]

    run(0)  # warm-up: cuDNN's first choices, the kernels' first launches
    sync()
    t0 = time.perf_counter()
    for i in range(1, steps + 1):
        run(i)
    sync()
    fps = batch * steps / (time.perf_counter() - t0)
    record = {"metric": "query_poses_per_sec_per_chip", "value": round(fps, 2), "unit": "poses/sec",
              "vs_baseline": round(fps / REFERENCE_FPS, 2)}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main(model_cfg=load_config(str(CONFIGS_DIR), sys.argv[1:]).get("model"))
