"""The readings that the check's limits are set from, on the card at a
cell's own size: ``python -m solbench.readings --workload <cell>
--seeds 1,2,... [--system port|control|<fault>] [--seconds S] [--out
FILE]``.  Each seed runs the cell in this process as ``python -m
solbench`` would (a short window: ``--seconds``, default 0, is one frame
or step after the set-up), with the program, the control (the
reference in bfloat16 in its place) or a fault of ``faults.py``, and
prints one JSON line of the compared numbers."""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from solbench import faults, harness, manifest, systems


def _systems(mode: str) -> dict:
    if mode == "frames":
        return {"port": systems.PortFrames, "control": faults.control_frames,
                **faults.FRAME_FAULTS}
    return {"port": systems.PortGrad, "control": faults.control_grad,
            **faults.GRAD_FAULTS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--system", default="port")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = manifest.Cell(args.workload)
    make = _systems(cell.workload["mode"])[args.system]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        notes = []
        res = harness.run(cell, seed, args.seconds, False, args.device, t0,
                          make_system=make, notes=notes)
        line = json.dumps({"workload": args.workload, "system": args.system,
                           "seed": seed, "correct": res["correct"],
                           "seconds": time.perf_counter() - t0,
                           "numbers": {k: v["value"] for k, v in
                                       res["check"].items()},
                           "notes": notes})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        if torch.device(args.device).type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
