"""Readings from which a cell's limits are set: the compared numbers of the
program and of its control (the float32 reference at TF32, put in the
program's place) at the cell's own size, over many seeds in one process.

    python3 -m annbench.calibrate --workload <name> --seeds 1,2,3 \
        --seconds 3 [--fault NAME] [--out FILE]

Each seed makes its own vectors and index, runs a short window at the
cell's own load, and reads the program's numbers and the control's on the
same index; one JSON line a seed. With `--fault` the program runs with
that fault of `faults.py` planted, and only its numbers are read. The
benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from annbench import faults, harness
from annbench.reference.precision import set_f32


def reading(workload: str, seed: int, seconds: float, device="cuda:0",
            control: bool = True) -> dict:
    """One seed's program and control numbers, with its end-to-end metrics
    and the seconds each reading took."""
    t0 = time.perf_counter()
    ctx = harness.Ctx(harness.manifest(), workload, seed, seconds, False, device)
    drv = harness.driver(ctx)
    ctx.state = drv.setup(ctx)
    setup_s = time.perf_counter() - t0
    ctx.rec = drv.window(ctx, seconds)
    e2e = drv.end_to_end(ctx)
    t1 = time.perf_counter()
    prog = drv.numbers(ctx, control=False)
    t2 = time.perf_counter()
    ctrl = drv.numbers(ctx, control=True) if control else None
    out = {"workload": workload, "seed": seed, "setup_s": setup_s, "e2e": e2e,
           "program": prog, "control": ctrl, "program_s": t2 - t1,
           "control_s": time.perf_counter() - t2}
    ctx.state = ctx.rec = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("annbench.calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    set_f32()
    lines = []
    for s in a.seeds.split(","):
        if a.fault:
            with faults.planted(a.fault):
                r = dict(reading(a.workload, int(s), a.seconds, control=False), fault=a.fault)
        else:
            r = reading(a.workload, int(s), a.seconds)
        line = json.dumps(r, default=float)
        print(line, flush=True)
        lines.append(line)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
