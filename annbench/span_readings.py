"""The span metrics of a cell with and without the profiler's cost per
operator.

    python3 -m annbench.span_readings --workload glove100.batch --seed 7 \
        --calls 8 --rounds 2

A `--trace 1` run reads the program's spans under a CPU + CUDA profiler,
which records every operator on the host and so slows a host-bound call.
This sets up the cell as its driver does and makes the cell's calls (a
search pass over all queries, or a build) in four modes, in turn, for
each round:

- `none`: no profiler; the spans record nothing. Each call's wall seconds,
  and for a build the `timings=` share of its `kmeans` phase;
- `spans`: no profiler, the program's spans made to record all the same
  (its profiler switch forced on, its profiler event left out): the host
  readings of the spans at the spans' own cost alone;
- `cuda`: a profiler with CUDA activity alone: the spans record and the
  device's operations are traced, the host's operators are not;
- `full`: CPU and CUDA activity, as a traced run's slice.

In the profiled modes the program's spans and the device's operations
share the host's nanosecond clock, so the idle time is given to the
innermost span without an alignment (`annbench/spans.py::attribute`). The
window runs from the first call's root span to the last call's end. One
JSON line on standard output: per mode and round, the median call seconds
and the readings of the cell's span metrics.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from annbench import harness, program, spans, tracing

CELLS = {"batch": ("engine.search_request", "search.tile"),
         "build": ("build", "kmeans.seed")}
ACTS = {"cuda": [torch.profiler.ProfilerActivity.CUDA],
        "full": [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]}


class _NoEvent:
    """The profiler event a span makes, left out where no profiler runs."""

    def __init__(self, name):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _readings(events, recs, root: str, inner: str) -> dict:
    """The host readings of the spans, and with the profiler's `events` the
    device's idle share and the part of it inside the `inner` spans."""
    roots = [r for r in recs if r.parent == 0 and r.name == root]
    if not roots:
        return {"spans": len(recs)}
    base = min(r.start_ns for r in roots)
    t1 = (max(r.end_ns for r in roots) - base) * 1e-9
    placed = [spans.Placed(r.name, (r.start_ns - base) * 1e-9, (r.end_ns - base) * 1e-9,
                           r.id, r.parent, r.request, r.counts)
              for r in recs if r.start_ns >= base]
    dur = lambda name: [p.end - p.start for p in placed if p.name == name]  # noqa: E731
    out = {"spans": len(recs), "window_s": t1,
           "mean_us": 1e6 * statistics.mean(dur(inner)),
           "share_pct": 100.0 * sum(dur(inner)) / sum(dur(root))}
    if events is None:
        return out
    kernels = sorted(((e.name(), (tracing._ns(e, "start") - base) * 1e-9,
                       tracing._ns(e, "duration") * 1e-9) for e in events
                      if e.device_type() == torch.autograd.DeviceType.CUDA),
                     key=lambda k: k[1])
    tr = tracing.Trace(kernels, [], 0.0, t1)
    r = spans.Reading(placed, *spans.attribute(spans.idle_intervals(tr), placed), 0.0)
    within = spans._within(r, inner)
    out["idle_pct"] = 100.0 * (t1 - tr.busy_s()) / t1
    out["idle_in_pct"] = 100.0 * sum(s for i, s in r.idle.items() if i in within) / t1
    return out


def measure(ctx, calls: int, rounds: int, acts=None) -> dict:
    """Each round, `calls` calls of the cell in each mode (`none`, `spans`,
    then each of `acts`, a profiler's activities by mode), the state set up
    first."""
    program._path()
    from repro_torch import spans as ps
    acts = ACTS if acts is None else acts
    kind = ctx.cell["traffic"]
    root, inner = CELLS[kind]
    switch = ps._enabled, ps._Event
    ctx.state = harness.driver(ctx).setup(ctx)
    tracing.note("set up")

    def call() -> dict:
        tm: dict = {}
        if kind == "batch":
            s = ctx.state
            s["engine"].search_request(s["Qn"], s["params"])
        else:
            program.build_index(ctx.cfg, ctx.state["v"].X, ctx.seed, ctx.device, timings=tm)
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        return tm

    out: dict = {"workload": ctx.workload, "seed": ctx.seed, "inner": inner, "modes": {}}
    for rnd in range(rounds):
        for mode in ["none", "spans", *acts]:
            ps.reset()
            secs, tms = [], []
            prof = torch.profiler.profile(activities=acts[mode]) if mode in acts else None
            if prof is not None:
                prof.__enter__()
            if mode == "spans":
                ps._enabled, ps._Event = (lambda: True), _NoEvent
            try:
                for _ in range(calls):
                    t = time.perf_counter()
                    tms.append(call())
                    secs.append(time.perf_counter() - t)
            finally:
                ps._enabled, ps._Event = switch
            if prof is not None:
                prof.__exit__(None, None, None)
            row = {"call_s": statistics.median(secs)}
            if kind == "build":
                row["kmeans_share_pct"] = 100.0 * statistics.median(
                    t["kmeans"] / sum(t.values()) for t in tms)
            else:
                tiles = -(-ctx.state["Qn"].shape[0] // ctx.cfg["engine"]["bq"])
                row["call_us_a_tile"] = 1e6 * row["call_s"] / tiles
            if mode != "none":
                events = prof.profiler.kineto_results.events() if prof is not None else None
                row.update(_readings(events, ps.spans(), root, inner))
            out["modes"].setdefault(mode, []).append(row)
            tracing.note(f"round {rnd} {mode}: {json.dumps(row)}")
    ps.reset()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, default=8, help="calls a mode a round")
    ap.add_argument("--rounds", type=int, default=2)
    a = ap.parse_args(argv)
    ctx = harness.Ctx(harness.manifest(), a.workload, a.seed, 0, True, "cuda:0")
    out = measure(ctx, a.calls, a.rounds)
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
