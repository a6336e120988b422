"""Query-pose inference over a data-parallel mesh: the objects of the query
cell through ``run_inference(mesh=)``, one process a GPU.

The harness's process is rank 0 on the context's device. Its set-up starts
ranks 1 to world - 1 (``python -m benchmark.drivers.query_mesh``, each on
``cuda:<rank>``, or the CPU over gloo), and every rank joins the process
group with a timeout of ``timeout_s`` (every collective's too), builds the
objects, the clouds and the weights from the seed as the query cell's driver
does (``benchmark.drivers.query``), and then runs what rank 0 broadcasts: an
object through ``run_inference(..., frame_batch=..., mesh=)``, which runs
frame_batch / world frames of each batch on each rank and all-gathers the
results, or the end. A rank that exits early ends rank 0 at once (its
watcher), and a rank whose parent is gone exits; ``release()`` ends the
ranks, destroys the group and joins them under a timeout, then kills any
left. Rates are on rank 0's clock.

The numbers compared once the window has closed (PERF.md §6):

- ``match_tail``: as in the query cell, on frames drawn from the seed over
  the window's units; the rank that ran each drawn frame returns the
  program's matches for it, so a rank that computes wrongly is seen.
- ``gather_exact``: the share of the gathered rows (a frame's pose words,
  inliers, ok, errors and match count, bitwise) on rank 0 that differ from
  the row the rank that owns the frame computed locally, over every frame of
  the window. A sound run reads 0; a gather that leaves a rank out, or
  misorders a batch, reads a quarter or more at world 4.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import threading
import time
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from . import query

RUN, CHECK = 1, 2


def pack_rows(poses, inliers, ok, r_err, t_err, n_match) -> np.ndarray:
    """[F, 21] int32: a frame's pose as 16 float32 words, then inliers, ok,
    the two errors' float32 words and the match count."""
    f32 = lambda a: np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)  # noqa: E731
    n = len(poses)
    return np.concatenate([f32(poses).reshape(n, 16), np.asarray(inliers).astype(np.int32)[:, None],
                           np.asarray(ok).astype(np.int32)[:, None], f32(r_err)[:, None], f32(t_err)[:, None],
                           np.asarray(n_match).astype(np.int32)[:, None]], 1)


class Driver(query.Driver):
    def __init__(self, ctx, rank: int = 0, port: int = 0):
        super().__init__(ctx)
        self.rank, self.world = rank, ctx.cell["chips"]
        self.port, self.procs, self.mesh = port, [], None
        fb = self.tr["frame_batch"]
        if fb % self.world:
            raise ValueError(f"frame_batch {fb} is not a multiple of {self.world} ranks")
        self.share = fb // self.world

    # ------------------------------------------------------------ set-up
    def setup(self):
        from onepose_plus_plus_tpu_torch.parallel.mesh import Mesh, free_port

        cuda = self.dev.type == "cuda"
        if self.rank == 0:
            if cuda:  # build the kernels once, before the other ranks look for them
                from onepose_plus_plus_tpu_torch.kernels import build
                build()
            self.port = free_port()
            self._spawn()
        timeout = datetime.timedelta(seconds=self.tr["timeout_s"])
        backend = "nccl" if cuda else "gloo"
        if cuda:
            if self.dev.index is None:  # "cuda" names the current device; NCCL needs its index
                self.dev = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.set_device(self.dev)
        dist.init_process_group(backend, init_method=f"tcp://localhost:{self.port}", rank=self.rank,
                                world_size=self.world, timeout=timeout)
        self.mesh = Mesh(rank=self.rank, world=self.world, device=self.dev, backend=backend)
        super().setup()
        self.units: List[tuple] = []  # (object index, first record, this rank's rows, rank 0's gathered rows)

    def _spawn(self):
        """Start ranks 1 .. world - 1, each told the cell, the seed and the port,
        their standard output sent to standard error; a watcher ends this
        process as soon as one of them exits before the end."""
        ctx = {"cell": self.ctx.cell, "config": self.ctx.config, "traffic": self.tr, "seed": self.ctx.seed,
               "control": self.ctx.control, "device": self.dev.type, "port": self.port}
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        for r in range(1, self.world):
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "benchmark.drivers.query_mesh", "--rank", str(r), "--context", json.dumps(ctx)],
                cwd=root, stdout=sys.stderr))
        self.ending = False

        def watch():
            while not self.ending:
                for p in self.procs:
                    if p.poll() not in (None, 0) and not self.ending:
                        print(f"[query_mesh] a rank exited with {p.returncode}; ending", file=sys.stderr, flush=True)
                        os._exit(1)
                time.sleep(0.5)
        threading.Thread(target=watch, daemon=True).start()

    def _fine_plan(self):
        return {}  # the fine stage is the query cell's to report

    # ------------------------------------------------------------ window
    def _command(self, op: int, arg: int = 0) -> tuple:
        """Rank 0's command, broadcast to every rank: (op, arg)."""
        t = torch.tensor([op, arg], dtype=torch.int64, device=self.dev)
        dist.broadcast(t, 0)
        return int(t[0]), int(t[1])

    def _run(self, obj):
        from onepose_plus_plus_tpu_torch.inference.pipeline import run_inference
        t = self.tr
        return run_inference(self.model, obj["frames"], obj["cloud"], shape3d=t["shape3d"],
                             frame_batch=t["frame_batch"], rng_seed=obj["index"], step=self._step, mesh=self.mesh)

    def _step(self, *args):
        """The query step, its outputs kept (device tensors, no copy)."""
        out = self.step(*args)
        self.local.append(out)
        return out

    def _object(self, o: int, record: bool) -> None:
        obj = self.objects[o]
        self.local = []
        first = len(self.records)
        self.unit_index = len(self.units) if record else None
        self.unit_first = first
        res = self._run(obj)
        self.unit_index = self.rows = None
        if record:
            self.units.append((o, first, self.local,
                               pack_rows(res.poses, res.num_inliers, res.ok, res.R_errs, res.t_errs, res.num_matches)
                               if self.rank == 0 else None))
        else:
            self.records.clear()

    def warm(self):
        self._command(RUN, -1)
        self._object(0, False)

    def unit(self) -> Dict[str, float]:
        o = self.next % len(self.objects)
        self.next += 1
        self._command(RUN, o)
        self._object(o, True)
        return {"frames": len(self.objects[o]["frames"]), "objects": 1, "units": 1}

    def serve(self) -> None:
        """Ranks 1 .. world - 1: run rank 0's commands until the check."""
        while True:
            op, arg = self._command(0)
            if op == RUN:
                self._object(max(arg, 0), arg >= 0)
            elif op == CHECK:
                self._payload()
                return

    # ------------------------------------------------------------- check
    def _picks(self) -> np.ndarray:
        """The (unit, frame) picks of ``match_tail``, as ``unit * n + frame``."""
        c, n = self.tr["check"], self.tr["frames_per_object"]
        rng = np.random.default_rng(self.ctx.seed)
        return rng.choice(len(self.units) * n, size=min(c["frames"], len(self.units) * n), replace=False)

    def _payload(self) -> list:
        """Every rank's part of the check, gathered on every rank: its rows of
        each unit, and its matches of the drawn frames it ran."""
        fb, n = self.tr["frame_batch"], self.tr["frames_per_object"]
        rows = [np.concatenate([pack_rows(*(x.cpu().numpy() for x in out)) for out in local])
                for _, _, local, _ in self.units]
        picks = self._picks()
        matches = {}
        for d in sorted(set(picks // n)):
            o, first, _, _ = self.units[d]
            frames = np.sort(picks[picks // n == d] % n)
            mine = frames[(frames % fb) // self.share == self.rank]
            if len(mine):
                matches[int(d)] = self._own_matches(self.objects[o], first, mine)
        parts = [None] * self.world
        dist.all_gather_object(parts, {"rows": rows, "matches": matches})
        return parts

    def _own_matches(self, obj, first: int, frames: np.ndarray) -> dict:
        """This rank's matches of the given frames (each in its share of a
        batch), with the benchmark's point ids."""
        fb = self.tr["frame_batch"]
        perm = self._perm(obj, self.records[first][0])
        out = {"frames": frames}
        for k, j in (("i_ids", 1), ("j_ids", 2), ("mconf", 3), ("mask", 4)):
            out[k] = np.stack([self.records[first + f // fb][j][f % fb - self.rank * self.share].cpu().numpy()
                               for f in frames])
        out["i_ids"] = perm[out["i_ids"].astype(np.int64)]
        return out

    def release(self):
        self.parts = None
        try:
            self._command(CHECK)
            self.parts = self._payload()
        finally:
            self.ending = True
            dist.destroy_process_group()
            for p in self.procs:
                try:
                    p.wait(timeout=self.tr["join_s"])
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        super().release()

    def _program_matches(self, obj, d: int, n_frames: int):
        """The drawn frames' matches of unit ``d``, from the ranks that ran them."""
        got = [p["matches"][d] for p in self.parts if d in p["matches"]]
        frames = np.concatenate([g["frames"] for g in got])
        return frames, {k: np.concatenate([g[k] for g in got]) for k in ("i_ids", "j_ids", "mconf", "mask")}

    def check(self) -> Dict[str, float]:
        """``match_tail`` and ``conf_tail`` as the query cell's, and
        ``gather_exact``."""
        differ = total = 0
        fb, b = self.tr["frame_batch"], self.share
        for d, (_, _, _, gathered) in enumerate(self.units):
            for s in range(0, len(gathered), fb):  # batch s // fb: rank r ran its rows [r b, (r + 1) b)
                k = s // fb
                mine = np.concatenate([p["rows"][d][k * b:(k + 1) * b] for p in self.parts])
                g = gathered[s:s + fb]
                differ += int((g != mine[:len(g)]).any(1).sum())
                total += len(g)
        n = self.tr["frames_per_object"]
        picks = self._picks()
        ref = query.OnePosePlus(self.model_cfg).to(self.dev).eval()
        ref.load_state_dict(self.weights)
        tally = np.zeros(4)
        for d in sorted(set(picks // n)):
            o = self.units[d][0]
            tally += self._check_object(ref, self.objects[o], d, np.sort(picks[picks // n == d] % n))
        return {"match_tail": float(tally[0] / tally[1]) if tally[1] else 1.0,
                "conf_tail": float(tally[2] / tally[3]) if tally[3] else 1.0,
                "gather_exact": float(differ / total) if total else 1.0}


def main(argv=None) -> int:
    """A rank other than 0: its context from rank 0, then its commands."""
    from ..harness import Context
    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--context", required=True)
    args = p.parse_args(argv)
    c = json.loads(args.context)
    parent = os.getppid()

    def orphaned():  # rank 0 gone: leave rather than wait for the collective's timeout
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)
    threading.Thread(target=orphaned, daemon=True).start()
    device = torch.device("cuda", args.rank) if c["device"] == "cuda" else torch.device("cpu")
    drv = Driver(Context(c["cell"], c["config"], c["traffic"], c["seed"], device, control=c["control"]),
                 rank=args.rank, port=c["port"])
    drv.setup()
    drv.serve()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
