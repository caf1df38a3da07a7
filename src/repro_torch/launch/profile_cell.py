"""Per-cell roofline profile (PyTorch port of `repro/launch/profile_cell.py`):
the top HBM and collective contributors of one device's step, from the
op-counting dry run (`launch/dryrun.py`, the §Perf iteration tool).

    PYTHONPATH=src python -m repro_torch.launch.profile_cell --arch xlstm-350m \
        --shape train_4k [--mesh single]

JAX groups its contributors by HLO computation and instruction; here each
row is one aten op at one output shape, with the number of calls that
make up its bytes (`op_analysis.analyze(top_n=)`). The terms' rates are
one H100 SXM's (`launch/dryrun.py`).
"""
from __future__ import annotations

import argparse

from repro_torch.configs import ARCH_IDS
from repro_torch.launch.dryrun import HBM_BW, collective_bw, compute_s, run_cell
from repro_torch.models.config import SHAPES


def profile(arch: str, shape: str, multi_pod: bool = False, top_n: int = 12) -> dict:
    """Count the cell with its top contributors, print them → the result."""
    r = run_cell(arch, shape, multi_pod, save=False, top_n=top_n)
    print(f"== {arch} {shape} {'multi' if multi_pod else 'single'}")
    if "skipped" in r:
        print(f"skipped: {r['skipped']}")
        return r
    pd, mem = r["per_device"], r["memory"]
    print(f"terms: compute {compute_s(pd['flops_by_dtype']):.3f}s  "
          f"memory {pd['bytes_accessed'] / HBM_BW:.3f}s  "
          f"collective {r['collective_bytes_total'] / collective_bw(r['n_chips']):.3f}s")
    print(f"peak mem: args {mem['argument_bytes'] / 2**30:.2f} + temp "
          f"{mem['temp_bytes'] / 2**30:.2f} GiB")
    print("-- top HBM contributors:")
    for c in r["top_hbm"]:
        print(f"  {c['bytes']:.3g}B x{c['calls']} {c['op'][:24]:24s} {c['type']}")
    print("-- top collective contributors:")
    for c in r["top_coll"]:
        print(f"  {c['bytes']:.3g}B x{c['calls']} {c['op'][:24]:24s} {c['type']}")
    return r


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    profile(args.arch, args.shape, args.mesh == "multi", args.top)


if __name__ == "__main__":
    main()
