"""Multi-pod dry run of the LM cells (PyTorch port of
`repro/launch/dryrun.py`): one device's train, prefill or decode step at
production scale, counted without the cluster.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

JAX lowers every (arch × shape × mesh) cell over its production mesh and
asks XLA. Here the per-device program runs: a "fake" process group of
256 or 512 ranks (torch's testing backend, whose collectives move
nothing) holds the production `DeviceMesh` (`launch/mesh.py`), the cell's
parameters, optimizer state, batch and caches are meta DTensors placed by
the cell's rules (`launch/specs.py`), and the step runs on them under
`launch/op_analysis.py`, which counts this rank's local ops and the
collectives DTensor issues. Results go to
artifacts/dryrun_torch/<arch>_<shape>_<mesh>.json, with JAX's keys
(`compile_s` is the traced call's host seconds; the port compiles
nothing).

The roofline's rates are one H100 SXM's. JAX's constants are a TPU
v5e's; these are the card's published peaks. A collective's rate depends
on where its group lies:

- inside one node of 8 cards, NVLink: 450e9 B/s each way per card;
- across nodes, the card's own network port: 400 Gb/s NDR InfiniBand,
  50e9 B/s each way, one port a card as in NVIDIA's DGX H100.

The 256- and 512-device meshes are 32 and 64 nodes of 8, so every ring
step that leaves a node runs at the network's rate, and a ring is as fast
as its slowest step: `collective_bw` gives the network's rate to any
group of more than 8 cards.
"""
from __future__ import annotations

import argparse
import json
import os
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config, get_rule_overrides
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import build_rules, make_production_mesh, set_mesh
from repro_torch.launch.op_analysis import analyze
from repro_torch.models import params as prm
from repro_torch.models.config import SHAPES, cell_applicable
from repro_torch.models.layers import get_logical_rules, set_logical_rules

OUT_DIR = os.path.join("artifacts", "dryrun_torch")

# The H100 SXM's published dense peaks (NVIDIA's data sheet; no sparsity),
# for the dtypes the port computes in. Its TF32 peak, 495e12, prices no
# product: the port keeps TF32 off.
PEAK_FLOPS = {
    "bfloat16": 989e12,             # tensor cores
    "float32": 67e12,               # outside the tensor cores
}
HBM_BW = 3.35e12                    # bytes/s, the H100 SXM's HBM3
NVLINK_BW = 450e9                   # bytes/s each way per card, inside a node
NET_BW = 50e9                       # bytes/s: 400 Gb/s NDR, one port a card
NODE_CARDS = 8


def collective_bw(n_chips: int) -> float:
    """Bytes/s of one card's collective traffic in a group of n_chips:
    NVLink inside one node, the network port beyond it."""
    return NVLINK_BW if n_chips <= NODE_CARDS else NET_BW


def compute_s(flops_by_dtype: dict) -> float:
    """Seconds of the products, each dtype's FLOPs at its own peak. f32
    products run outside the tensor cores: the port keeps TF32 off
    (`utils.set_f32_precision`)."""
    return sum(f / PEAK_FLOPS[dt] for dt, f in flops_by_dtype.items())


def fmt_summary(r: dict) -> str:
    """JAX's one-line summary of a dry-run result."""
    if "skipped" in r:
        return (f"{r['arch']:22s} {r['shape']:12s} {r['mesh']:6s} "
                f"SKIP ({r['skipped']})")
    rf = r["roofline"]
    mem_gb = r["memory"]["peak_bytes"] / 2**30
    return (f"{r['arch']:22s} {r['shape']:12s} {r['mesh']:6s} "
            f"compile {r['compile_s']:6.1f}s mem {mem_gb:6.2f}GiB "
            f"compute {rf['compute_s']:.3g}s mem-term {rf['memory_s']:.3g}s "
            f"coll {rf['collective_s']:.3g}s → {rf['dominant']}"
            f" useful={rf['useful_flops_ratio']:.2f}")


def fake_group(world: int) -> None:
    """Initialise torch's "fake" backend (collectives that move nothing)
    as the default group of `world` ranks, this one rank 0."""
    if dist.is_initialized():
        raise RuntimeError("dry run: a default process group already exists; "
                           "the dry run makes its own fake group and will not "
                           "reuse another")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("the dry run needs torch's fake process-group backend "
                           "(torch.testing._internal.distributed.fake_pg), which "
                           "this torch lacks") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _place(args, specs, mesh):
    """Each argument as DTensors under its spec tree (None: as it is)."""
    return tuple(a if s is None else prm.distribute(a, s, mesh)
                 for a, s in zip(args, specs))


def place_out(out, specs, mesh):
    if isinstance(out, tuple) and not hasattr(out, "_fields"):
        return _place(out, specs, mesh)
    return prm.distribute(out, specs, mesh)


def count_cell(cfg, cell, rules: dict, mesh, multi_pod: bool, top_n: int = 0) -> dict:
    """One device's step of `cell` on `mesh` under `rules`, counted by
    `op_analysis.analyze` (its result; the outputs placed by the cell's
    out specs inside the count, as JAX's out_shardings are)."""
    if cell.kind == "train":
        fn, args, in_sh, out_sh = S.train_cell_specs(cfg, cell, rules, multi_pod)
    elif cell.kind == "prefill":
        fn, args, in_sh, out_sh = S.prefill_cell_specs(cfg, cell, rules)
    else:
        fn, args, in_sh, out_sh = S.decode_cell_specs(cfg, cell, rules)
    before = get_logical_rules()
    set_logical_rules(rules)
    try:
        with set_mesh(mesh), torch.set_grad_enabled(cell.kind == "train"):
            placed = _place(args, in_sh, mesh)
            return analyze(lambda *a: place_out(fn(*a), out_sh, mesh), *placed,
                           top_n=top_n)
    finally:
        set_logical_rules(before)


def cell_rules(arch: str, cfg, cell, multi_pod: bool, rules_extra: dict | None = None) -> dict:
    """The rules of one (arch × shape × mesh) cell, as JAX's run_cell
    resolves them (decode: `serve_rules`)."""
    overrides = dict(get_rule_overrides(arch))
    if rules_extra:
        overrides.update(rules_extra)
    rules = build_rules(overrides, multi_pod=multi_pod, batch_size=cell.global_batch)
    if cell.kind == "decode":
        # per-STEP param re-gather dominates decode; prefill amortizes the
        # gather over the whole sequence, so it keeps FSDP
        rules = S.serve_rules(cfg, rules)
    return rules


def summarize(arch: str, shape_name: str, mesh_name: str, cfg, cell, rules: dict,
              an: dict, n_chips: int) -> dict:
    """JAX's result keys from one counted step."""
    bw = collective_bw(n_chips)
    terms = {"compute_s": compute_s(an["flops_by_dtype"]),
             "memory_s": an["hbm_bytes"] / HBM_BW,
             "collective_s": an["collective_bytes_total"] / bw}
    mf = S.model_flops(cfg, cell)
    return dict(
        arch=arch, shape=shape_name, mesh=mesh_name,
        rules={k: str(v) for k, v in rules.items()},
        lower_s=0.0, compile_s=round(an["seconds"], 2),
        per_device=dict(flops=an["flops"], flops_by_dtype=an["flops_by_dtype"],
                        bytes_accessed=an["hbm_bytes"], output_bytes=an["output_bytes"],
                        n_ops=an["n_ops"]),
        memory=dict(argument_bytes=an["argument_bytes"], output_bytes=an["output_bytes"],
                    temp_bytes=an["temp_bytes"],
                    peak_bytes=an["temp_bytes"] + an["argument_bytes"]),
        collectives={k: v for k, v in an["collectives"].items() if v["count"]},
        collective_bytes_total=an["collective_bytes_total"],
        roofline=dict(
            **{k: float(f"{v:.6g}") for k, v in terms.items()},
            dominant=max(terms, key=terms.get),
            model_flops_total=mf,
            model_flops_per_device=mf / n_chips,
            useful_flops_ratio=float(f"{(mf / n_chips) / max(an['flops'], 1):.4g}"),
            collective_bw=bw,
            bound_step_s=float(f"{max(terms.values()):.6g}"),
        ),
        n_chips=n_chips,
    )


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             rules_extra: dict | None = None, save: bool = True,
             top_n: int = 0) -> dict:
    """Count one device's step of the cell on the production mesh and
    write its JSON → the result (with top_n, also `top_hbm` / `top_coll`)."""
    cfg = get_config(arch)
    cell = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    ok, why = cell_applicable(cfg, cell)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if not ok:
        result["skipped"] = why
        return result
    n_chips = 512 if multi_pod else 256
    rules = cell_rules(arch, cfg, cell, multi_pod, rules_extra)
    fake_group(n_chips)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        an = count_cell(cfg, cell, rules, mesh, multi_pod, top_n=top_n)
    finally:
        dist.destroy_process_group()
    result.update(summarize(arch, shape_name, mesh_name, cfg, cell, rules, an, n_chips))
    if top_n:
        result["top_hbm"], result["top_coll"] = an["top_hbm"], an["top_coll"]
    if save:
        os.makedirs(OUT_DIR, exist_ok=True)
        path = os.path.join(OUT_DIR, f"{arch}_{shape_name}_{mesh_name}.json")
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    archs = list(ARCH_IDS) if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    failures = 0
    for a in archs:
        for s in shapes:
            for mp in meshes:
                try:
                    print(fmt_summary(run_cell(a, s, mp)), flush=True)
                except Exception as e:      # a cell's failure is reported, the rest run
                    failures += 1
                    print(f"{a:22s} {s:12s} {'multi' if mp else 'single':6s} "
                          f"FAILED: {type(e).__name__}: {e}", flush=True)
                    traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} cells failed")
    print("all cells passed")


if __name__ == "__main__":
    main()
