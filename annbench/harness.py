"""The harness: finds a cell's pieces by name and runs it.

`BENCHMARK.json` (at the root of the checkout) names each cell's
configuration and traffic. The harness finds, by name alone:

- the configuration: the file the manifest gives it (`configs/<name>.json`);
- the traffic mix: `mixes/<traffic>.json`, whose `driver` names
  `drivers/<driver>.py`;
- each per-layer metric: a reader `metrics/<metric>.py` (`UNIT`, `SOURCE`,
  `read(ctx)`);
- the cell's limits: `limits/<workload>.json`.

A new configuration, mix, driver or metric is a new file and a manifest
entry; no existing file changes.

A run: set-up (data, build, warm-up; `setup_s` on the host clock from the
start of the run), the measured window, with `--trace 1` a profiled slice of
the same work after it, the device's peak memory, then the metrics and the
comparison with the reference, outside every window.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import torch

from annbench import compare, tracing
from annbench.compare import Check

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_S = 3.0          # length of the profiled slice of a --trace 1 run


class Ctx:
    """What a driver and a metric reader are given: the cell, its
    configuration and mix, the run's arguments, and (filled as the run
    goes) the driver's state, the window's record, the traced slice's
    record and its trace."""

    def __init__(self, man: dict, workload: str, seed: int, seconds: float,
                 trace: bool, device, bench_dir: Path = BENCH):
        self.man = man
        self.bench_dir = bench_dir
        self.cell = find(man["workloads"], workload)
        self.workload = workload
        conf = find(man["configs"], self.cell["config"])
        self.cfg = json.loads((bench_dir.parent / conf["file"]).read_text())
        self.mix = json.loads((bench_dir / "mixes" / f"{self.cell['traffic']}.json").read_text())
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = torch.device(device)
        self.state = None
        self.rec: dict = {}
        self.trace_rec: dict = {}
        self.tr: Optional[tracing.Trace] = None


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(entries: List[dict], name: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no entry named {name!r}")


def load(path: Path) -> ModuleType:
    """Import a file of the benchmark by its path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"annbench_file_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(ctx: Ctx) -> ModuleType:
    return load(ctx.bench_dir / "drivers" / f"{ctx.mix['driver']}.py")


def reports(metric: dict, workload: str, e2e_of_cell: List[str]) -> bool:
    """Whether a metric belongs in this cell's line: its `workloads` list
    names the cell, or it has none and the cell reports what it moves (a
    per-layer metric) or every cell reports it (an end-to-end one)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_of_cell


def end_to_end(man: dict, workload: str) -> List[dict]:
    return [m for m in man["end_to_end"] if reports(m, workload, [])]


def per_layer(man: dict, workload: str) -> List[dict]:
    names = [m["name"] for m in end_to_end(man, workload)]
    return [m for m in man["per_layer"] if reports(m, workload, names)]


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's, its
    relatives' or the JAX package's (`repro_torch` is not `repro`)."""
    mods = sys.modules if modules is None else modules
    return sorted(m for m in mods if m.split(".")[0] in FORBIDDEN)


def device_info(device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(ctx: Ctx, t_start: Optional[float] = None, control: bool = False) -> dict:
    """Set-up, window, (traced slice), metrics and comparison → the
    result's fields, with `checks` as Check tuples."""
    t_start = time.perf_counter() if t_start is None else t_start
    drv = driver(ctx)
    ctx.state = drv.setup(ctx)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    setup_s = time.perf_counter() - t_start
    with tracing.gc_pauses() as pauses:
        ctx.rec = drv.window(ctx, ctx.seconds)
    tracing.note(f"window closed: {len(pauses)} collections of the oldest generation, "
                 f"longest {max(pauses, default=0.0) * 1e3:.1f} ms")
    if ctx.trace:
        ctx.trace_rec, ctx.tr = tracing.profiled(lambda: drv.traced(ctx, TRACE_S))
    device = device_info(ctx.device)
    out: Dict = {"attempted": int(ctx.rec["attempted"]), "failed": int(ctx.rec["failed"])}
    units = {m["name"]: m["unit"] for m in ctx.man["end_to_end"] + ctx.man["per_layer"]}
    metrics: Dict[str, dict] = {}
    if ctx.trace:
        for m in per_layer(ctx.man, ctx.workload):
            v = load(ctx.bench_dir / "metrics" / f"{m['name']}.py").read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": units[m["name"]]}
        device["busy_s"] = ctx.tr.busy_s()
        device["window_s"] = ctx.tr.window_s
        out["breakdown"] = {"device_ops": ctx.tr.top_ops(), "idle_gaps": ctx.tr.idle_gaps()}
        e2e = {}
    else:
        e2e = drv.end_to_end(ctx)
        e2e["setup_s"] = setup_s
        for m in end_to_end(ctx.man, ctx.workload):
            # a metric named <quantity>.<suffix> is the driver's <quantity>,
            # under a bound of its own in the cells it lists
            v = e2e[m["name"]] if m["name"] in e2e else e2e[m["name"].split(".")[0]]
            metrics[m["name"]] = {"value": float(v), "unit": units[m["name"]]}
    checks: List[Check] = compare.checks(drv.numbers(ctx, control=control),
                                         compare.limits(ctx.bench_dir, ctx.workload))
    out.update(correct=all(c.ok for c in checks), metrics=metrics, device=device,
               checks=checks)
    return out


def result_line(res: dict) -> str:
    """The run's last line: correct, attempted, failed, metrics, device,
    (breakdown), and last the compared numbers with their limits."""
    line = {k: res[k] for k in ("correct", "attempted", "failed", "metrics", "device")}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = {c.name: {"value": _num(c.value), "limit": c.limit} for c in res["checks"]}
    return json.dumps(line)


def _num(v: float):
    return v if math.isfinite(v) else str(v)


def check_lines(res: dict) -> List[str]:
    return [f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAIL'}"
            for c in res["checks"]]
