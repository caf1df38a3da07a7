"""Dry run of the distributed SOAR serving step at big-ann-benchmarks scale
(PyTorch port of `repro/launch/ann_dryrun.py`): what one device holds, and
what bounds one search step, without the cluster.

    PYTHONPATH=src python -m repro_torch.launch.ann_dryrun [--mesh single|multi|both]
        [--variant baseline|pq|both]

Per shard, as in JAX: 1M vectors, 2,500 partitions (the paper's 400
points a partition), PMAX 1,000 slots, f32 rerank rows, 1,024 queries,
top_t 40, k 10; 256 shards (single) or 512 (multi), one a device.

JAX lowers the search over its production mesh and asks XLA. Here the
per-device program itself runs: this device's one shard,
`abstract_sharded_ivf(_pq)(1, ...)`, and the queries, all on the "meta"
device (no storage), through `make_distributed_search(_pq)(group=...)`
of a "fake" process group of world 256 or 512 (torch's testing backend:
its collectives move nothing), under `launch/op_analysis.py`. The
per-device counts (arguments, product FLOPs, collective bytes) are the
program's own, so they equal JAX's but where the two programs differ:
the port's PQ stack holds `extent` (2,500 int32), and JAX's `jit` drops
`sizes` (2,500 int32), which its search never reads, from its arguments.
Temp and HBM bytes are eager and unfused (`op_analysis`), so they are
not JAX's. The roofline's rates are one H100's (`launch/dryrun.py`).

Results go to artifacts/dryrun_torch/ann_serve[_pq]_<mesh>.json.
"""
from __future__ import annotations

import argparse
import json
import os

import torch
import torch.distributed as dist

from repro_torch.core.distributed import (abstract_sharded_ivf,
                                          abstract_sharded_ivf_pq,
                                          make_distributed_search,
                                          make_distributed_search_pq)
from repro_torch.launch.dryrun import (OUT_DIR, HBM_BW, collective_bw, compute_s,
                                      fake_group, fmt_summary)
from repro_torch.launch.op_analysis import analyze

N_LOCAL = 1_000_000
C_LOCAL = 2_500
PMAX = 1_000          # ~2x mean partition size (spilled)
D = 100
NQ = 1_024
TOP_T = 40
FINAL_K = 10


def run(multi_pod: bool, pq: bool = False, *, pmax: int = PMAX,
        world: int | None = None) -> dict:
    """Count one device's search step and write its JSON → the result.
    `pmax` sizes the shard's partition table; `world` (the shard and
    device count) defaults to the mesh's 256 or 512."""
    mesh = "multi" if multi_pod else "single"
    n_chips = (512 if multi_pod else 256) if world is None else world
    q = torch.empty((NQ, D), dtype=torch.float32, device="meta")
    if pq:
        ivf = abstract_sharded_ivf_pq(1, N_LOCAL, C_LOCAL, pmax, D, D // 4)
    else:
        ivf = abstract_sharded_ivf(1, N_LOCAL, C_LOCAL, pmax, D)
    fake_group(n_chips)
    try:
        maker = make_distributed_search_pq if pq else make_distributed_search
        an = analyze(maker(top_t=TOP_T, final_k=FINAL_K, group=dist.group.WORLD),
                     ivf, q)
    finally:
        dist.destroy_process_group()
    bw = collective_bw(n_chips)
    terms = {"compute_s": compute_s(an["flops_by_dtype"]),
             "memory_s": an["hbm_bytes"] / HBM_BW,
             "collective_s": an["collective_bytes_total"] / bw}
    result = dict(
        arch="soar-ann-serve" + ("-pq" if pq else ""),
        shape=f"{n_chips}x{N_LOCAL // 1000}k_q{NQ}",
        mesh=mesh,
        compile_s=round(an["seconds"], 1),
        memory=dict(argument_bytes=an["argument_bytes"], temp_bytes=an["temp_bytes"],
                    output_bytes=an["output_bytes"],
                    peak_bytes=an["argument_bytes"] + an["temp_bytes"]),
        per_device=dict(flops=an["flops"], flops_by_dtype=an["flops_by_dtype"],
                        hbm_bytes=an["hbm_bytes"], kernels=an["kernels"],
                        n_ops=an["n_ops"], pmax=pmax),
        collectives={k: v for k, v in an["collectives"].items() if v["count"]},
        collective_bytes_total=an["collective_bytes_total"],
        roofline=dict(**{k: float(f"{v:.6g}") for k, v in terms.items()},
                      dominant=max(terms, key=terms.get),
                      model_flops_total=0, model_flops_per_device=0,
                      useful_flops_ratio=0, collective_bw=bw,
                      bound_step_s=max(terms.values())),
        n_chips=n_chips,
    )
    os.makedirs(OUT_DIR, exist_ok=True)
    tag = "ann_serve_pq" if pq else "ann_serve"
    size = "" if world is None else f"_world{world}"
    with open(os.path.join(OUT_DIR, f"{tag}_{mesh}{size}.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--variant", default="both", choices=["baseline", "pq", "both"])
    args = ap.parse_args(argv)
    variants = {"baseline": [False], "pq": [True], "both": [False, True]}[args.variant]
    for mp in {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]:
        for pq in variants:
            print(fmt_summary(run(mp, pq=pq)))


if __name__ == "__main__":
    main()
