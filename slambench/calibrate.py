"""The readings the limits of `limits/<cell>.json` are set from: one cell
on many seeds in one process, each a short window at the cell's own load
that holds the sessions a run's check samples, with every number of the
program, of the lower-precision controls on the same outputs, and of the
program with each named fault planted.

    python3 -m slambench.calibrate --workload <cell> --seeds 1,2,3 --seconds 8 \\
        [--faults dense_skipped,match_altered --fault-seeds 4,5,6]

One JSON line a run on standard output. On a card only, like a run."""

from __future__ import annotations

import argparse
import json
import sys

from slambench.run import ROOT, log


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--controls", default="tf32,bfloat16")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    args = p.parse_args(argv)

    import torch

    from slambench import faults
    from slambench.manifest import Cell
    from slambench.run import run

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        log("no CUDA card")
        return 2
    cell = Cell(ROOT, args.workload)
    controls = tuple(c for c in args.controls.split(",") if c)

    def one(seed, fault=""):
        res = run(cell, seed, args.seconds, False, "cuda", controls=controls)
        line = {"cell": cell.name, "seed": seed, "fault": fault, "correct": res["correct"],
                "checks": res["checks"], "readings": res.get("readings")}
        print(json.dumps(line, default=float), flush=True)

    for seed in [int(s) for s in args.seeds.split(",") if s]:
        one(seed)
    for name in [f for f in args.faults.split(",") if f]:
        undo = []

        def patch(obj, attr, value):
            undo.append((obj, attr, getattr(obj, attr)))
            setattr(obj, attr, value)

        faults.FAULTS[name][0](patch)
        try:
            for seed in [int(s) for s in args.fault_seeds.split(",") if s]:
                one(seed, name)
        finally:
            for obj, attr, value in reversed(undo):
                setattr(obj, attr, value)
    return 0


if __name__ == "__main__":
    sys.exit(main())
