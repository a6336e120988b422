"""The readings that a cell's limits are set from, in one process.

    python3 -m benchmark.readings --workload <cell> --seeds 1,2,... [--control-seeds 7,8,9] [--fault NAME]
                                  [--seconds 4]

For each seed, one run of the cell through ``harness.run_cell`` with a short
window (``--seconds``; the check compares what the run completed), with the
program as configured; then the same with the control, the program's own
lower-precision path (``Context.control``). With ``--fault``, one of the
faults of ``benchmark/tests/faults.py`` is planted in the program first (the
readings of a broken run). Prints one JSON line a run: the seed, whether it
was the control, ``correct`` under the traffic file's limits, and every
number the check computed. The benchmark's own runs never run the control or
a fault.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from . import harness


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--fault", default="", help="a fault of benchmark/tests/faults.py, by its constant's name")
    args = p.parse_args(argv)
    spec = harness.load_spec()
    cell, config, traffic = harness.load_cell(args.workload, spec)
    if args.fault:
        import pytest
        from .tests import faults
        getattr(faults, traffic["driver"])(pytest.MonkeyPatch(), getattr(faults, args.fault))
    device = torch.device(args.device)
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for s in filter(None, seeds.split(",")):
            t0 = time.perf_counter()
            ctx = harness.Context(cell, config, traffic, int(s), device, control=control)
            out = harness.run_cell(ctx, args.seconds, False, t0, spec)
            print(json.dumps({"fault": args.fault, "seed": int(s), "control": control, "correct": out["correct"],
                              "checks": out["numbers"], "units": out["attempted"],
                              "seconds": time.perf_counter() - t0}), flush=True)
            if device.type == "cuda":
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
