"""Run one cell of the benchmark of `repro_torch` on this machine's card.

    python3 -m annbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints, as the last line of standard output,
one JSON object (correct, attempted, failed, metrics, device, with
`--trace 1` breakdown, and last the compared numbers beside their limits),
and the compared numbers as the last lines of standard error. Exits with
another code than 0, printing no result, without a card, without the
program in the checkout, or when a module of JAX or the JAX package is
loaded.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

T_START = time.perf_counter()

from annbench import harness, program  # noqa: E402
from annbench.reference.precision import set_f32  # noqa: E402

CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    import torch
    man = harness.manifest()
    cell = harness.find(man["workloads"], a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"annbench: the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    if not program.present():
        print(f"annbench: the program is not in this checkout ({program.SRC})",
              file=sys.stderr)
        return 3
    for var, sub in CACHE_DIRS.items():       # fixed cache directories inside the checkout
        os.environ[var] = str(harness.ROOT / "build" / sub)
    set_f32()
    ctx = harness.Ctx(man, a.workload, a.seed, a.seconds, bool(a.trace), "cuda:0")
    res = harness.run_cell(ctx, t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"annbench: modules of JAX or the JAX package loaded: {found}", file=sys.stderr)
        return 4
    line = harness.result_line(res)
    print("\n".join(harness.check_lines(res)), file=sys.stderr, flush=True)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
