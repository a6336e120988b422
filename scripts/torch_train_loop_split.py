#!/usr/bin/env python3
"""Where the training CLI's wall per micro-batch goes, on one CUDA GPU.

    python3 scripts/torch_train_loop_split.py    # needs one CUDA GPU and nvcc

At the train config (f32, 4 frames of 512^2 a micro-batch, 7000 points,
grad_accum 2, TF32 off, as ``chip_smoke.py`` phases 7d and 7e), on the
capture phase 7e writes (48 frames):

- ``loader``: the ``TrainLoader``'s batches alone, ms a batch, with 4 worker
  threads and with none;
- ``pin``: ``parallel.mesh.shard_batch`` of one host batch (pinning and the
  side-stream copy) until the batch is ready on the card;
- ``step``: ``train_step`` on one batch already on the card, median of 8
  synchronised micro-batches: the model alone, and under DDP (world 1 over
  NCCL) with ``find_unused_parameters`` on (as ``replicate``) and off;
- ``cli``: the training CLI's own loop (``train.cli.main``, 12 micro-batches,
  no callbacks), ms a micro-batch over its last log interval (steps 9-12),
  with ``trainer.loader_workers`` 4 and 0.

Prints one JSON line (with the card's name and power limit).
"""
from __future__ import annotations

import contextlib
import io
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from onepose_plus_plus_tpu_torch.config import OnePosePlusConfig
    from onepose_plus_plus_tpu_torch.data.dataset import OnePosePlusTrainDataset, TrainLoader
    from onepose_plus_plus_tpu_torch.parallel import mesh as pmesh
    from onepose_plus_plus_tpu_torch.train import cli as train_cli
    from onepose_plus_plus_tpu_torch.train.train_step import TrainConfig, make_optimizer, train_step

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    out = {"gpu": smi}
    with tempfile.TemporaryDirectory() as tmp:
        manifest = cs._train_capture(tmp, 48)
        records = train_cli.load_records(manifest)
        dataset = OnePosePlusTrainDataset(records, img_size=cs.TRAIN_IMG, shape3d=cs.TRAIN_P,
                                          image_warp_adapt=False, seed=0)
        for workers in (4, 0):
            loader = TrainLoader(dataset, batch_size=cs.TRAIN_B, seed=0, num_workers=workers)
            t0 = time.perf_counter()
            batches = list(loader.epoch(0))
            out[f"loader_ms_per_batch_workers_{workers}"] = 1e3 * (time.perf_counter() - t0) / len(batches)
        host = {k: v for k, v in batches[0].items() if k in train_cli.BATCH_KEYS}

        m = pmesh.make_mesh("cuda", 0, 1)
        pins = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = pmesh.shard_batch(host, m).ready()
            torch.cuda.synchronize()
            pins.append(1e3 * (time.perf_counter() - t0))
        out["pin_and_copy_ms"] = float(np.median(pins[1:]))

        tc = TrainConfig(grad_accum=2)
        variants = (("model", None), ("ddp_find_unused", True), ("ddp", False))
        for tag, find_unused in variants:
            model = cs._train_model(OnePosePlusConfig(), "cuda")
            net = model if find_unused is None else torch.nn.parallel.DistributedDataParallel(
                model, device_ids=[m.device], broadcast_buffers=False, find_unused_parameters=find_unused)
            opt, sched = make_optimizer(model, tc, tc.true_lr(cs.TRAIN_B * 2), 1000)
            gen = torch.Generator(device="cuda")
            gen.manual_seed(0)
            walls = []
            try:
                for _ in range(10):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    train_step(net, opt, batch, gen, tc, sched)
                    torch.cuda.synchronize()
                    walls.append(1e3 * (time.perf_counter() - t0))
                out[f"step_ms_{tag}"] = float(np.median(walls[2:]))
            except RuntimeError as e:  # DDP refuses a graph with unused parameters when told there are none
                out[f"step_ms_{tag}"] = f"error: {str(e).splitlines()[0][:160]}"
            del net, model, opt
            torch.cuda.empty_cache()
        pmesh.release_mesh()

        for workers in (4, 0):
            argv = ["+experiment=train.yaml", f"dataset.train_anno_file={manifest}", "dataset.val_anno_file=null",
                    f"dataset.img_resize={cs.TRAIN_IMG}", f"dataset.shape3d_train={cs.TRAIN_P}",
                    "dataset.image_warp_adapt=false", "trainer.device=cuda", "trainer.n_devices=1",
                    f"trainer.batch_size={cs.TRAIN_B}", "trainer.epochs=1", "trainer.log_every_n_steps=4",
                    "trainer.enable_plotting=false", f"trainer.loader_workers={workers}",
                    f"ckpt_dir={tmp}/ckpts_{workers}", f"log_dir={tmp}/logs_{workers}"]
            stdout = io.StringIO()
            with contextlib.redirect_stdout(stdout):
                train_cli.main(argv)
            per = [float(x) for x in re.findall(r"([\d.]+) ms/micro-batch", stdout.getvalue())]
            out[f"cli_ms_per_micro_batch_workers_{workers}"] = per[-1]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
