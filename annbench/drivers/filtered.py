"""Closed-loop filtered search: every query of a call restricted to one
subset of the corpus (the NeurIPS'23 Big-ANN filter track's query shape).

Set-up first asks the program whether it serves the mix's `escalate` mode
(`ESCALATE_MODES` beside `SearchParams`), and stops at once where it does
not. It then makes the configuration's vectors from the seed, builds the
index through `AnnEngine`'s sharded build, draws each of the mix's filters
on the device from the seed (every id eligible with the filter's
selectivity) and warms the search under each. The window: one client calls
`AnnEngine.search_request` with all queries and one filter's bitmap,
alternating the filters, back to back, results on the host, until
`seconds` have passed and every filter has had as many calls (so the
traced slice's per-query counts do not depend on how many calls fit it);
`qps` is every query answered over the whole time.
`recall10` is the mean over the filters of the last answers' recall@10
against exact inner-product neighbours among the rows the filter passes.

Correctness: the index is judged as the batch cells judge it
(`compare.index`). Every distinct set of answers under a filter is judged
(`compare.answers`) on `check_per_filter` queries drawn from the seed,
against `reference/filtered.py`'s search under the same rule; besides,
over all its rows, `filter_bad` counts ids the filter does not pass and
`short_rows` rows with fewer than k ids where the filter passes at least
k of the index's ids.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

from annbench import compare, data, harness, program, tracing
from annbench.reference import filtered as rf

batch = harness.load(Path(__file__).with_name("batch.py"))
FILTER_SEED = 0x5F17E4ED          # filters' stream, apart from the vectors'


def check_program(ctx) -> None:
    """Stop unless the program serves the mix's escalate mode."""
    _, SearchParams, _, _ = program.api()
    modes = getattr(sys.modules[SearchParams.__module__], "ESCALATE_MODES", ())
    esc = ctx.mix["escalate"]
    if not any(esc is m or (isinstance(m, str) and m == esc) for m in modes):
        raise ValueError(f"the program has no escalate={esc!r} mode (it serves {modes!r})")


def filters(ctx, n: int) -> list:
    """The mix's filters, (n,) uint8 on the device, drawn from the seed."""
    g = data.generator(ctx.seed ^ FILTER_SEED, ctx.device)
    return [(torch.rand(n, generator=g, device=ctx.device) < f["selectivity"]).to(torch.uint8)
            for f in ctx.mix["filters"]]


def setup(ctx):
    check_program(ctx)
    cfg = ctx.cfg
    v = data.make(cfg["data"], ctx.seed, ctx.device)
    tracing.note("vectors made")
    _, SearchParams, _, _ = program.api()
    engine = program.engine_over(cfg, program.build_index(cfg, v.X, ctx.seed, ctx.device))
    tracing.note("index built")
    bits = filters(ctx, v.X.shape[0])
    masks = [b.cpu().numpy() for b in bits]
    params = [SearchParams(k=cfg["search"]["k"], filter_mask=m, escalate=ctx.mix["escalate"])
              for m in masks]
    Qn = v.Q.cpu().numpy()
    for _ in range(2):                       # the window's shapes, warmed
        for p in params:
            engine.search_request(Qn, p)
    tracing.note(f"search warmed; populations {[int(b.sum()) for b in bits]}")
    return {"v": v, "engine": engine, "params": params, "bits": bits, "Qn": Qn}


def _loop(ctx, seconds: float, keep: bool) -> dict:
    s = ctx.state
    engine, params, Qn = s["engine"], s["params"], s["Qn"]
    answers = [[] for _ in params]           # per filter: [ids, scores, count]
    last = [None] * len(params)
    passes, pass_s = 0, []
    t0 = time.perf_counter()
    while True:
        f = passes % len(params)
        t = time.perf_counter()
        with tracing.span("search_request"):
            r = engine.search_request(Qn, params[f])
        pass_s.append(time.perf_counter() - t)
        passes += 1
        if keep:
            last[f] = r.ids
            for a in answers[f]:
                if np.array_equal(a[0], r.ids) and np.array_equal(a[1], r.scores):
                    a[2] += 1
                    break
            else:
                answers[f].append([r.ids, r.scores, 1])
        if passes % len(params) == 0 and time.perf_counter() - t0 >= seconds:
            break                            # whole rounds: each filter as often
    elapsed = time.perf_counter() - t0
    q = sorted(pass_s)
    tracing.note(f"{passes} passes, seconds a pass: min {q[0]:.5f} median {q[len(q) // 2]:.5f} "
                 f"max {q[-1]:.5f}; by filter " + ", ".join(
                     f"{fl['name']} {np.median(pass_s[i::len(params)]):.5f}"
                     for i, fl in enumerate(ctx.mix["filters"]) if pass_s[i::len(params)]))
    nq = Qn.shape[0]
    failed = 0
    if keep:
        for f, sets in enumerate(answers):
            short = _short(ctx, f)
            failed += sum(int(short(a[0]).sum()) * a[2] for a in sets)
    return {"passes": passes, "elapsed_s": elapsed, "pass_s": pass_s, "nq": nq,
            "answers": answers, "last": last, "attempted": passes * nq, "failed": failed}


def _short(ctx, f: int):
    """Rows of (nq, k) ids with fewer than k ids, where the filter passes at
    least k of the index's ids."""
    k = ctx.cfg["search"]["k"]
    full = _population(ctx, f) >= k
    return lambda ids: ((ids >= 0).sum(1) < k) & full


def _population(ctx, f: int) -> int:
    memo = ctx.__dict__.setdefault("memo", {})
    if ("population", f) not in memo:
        st = program.index_state(ctx.state["engine"], ctx.state["v"].X)
        memo[("population", f)] = rf.population(st, ctx.state["bits"][f])
    return memo[("population", f)]


def window(ctx, seconds: float) -> dict:
    return _loop(ctx, seconds, keep=True)


def traced(ctx, seconds: float) -> dict:
    return _loop(ctx, seconds, keep=False)


def end_to_end(ctx) -> dict:
    rec, s = ctx.rec, ctx.state
    k = ctx.cfg["search"]["k"]
    recalls = []
    for f, ids in enumerate(rec["last"]):
        if ids is None:
            continue
        _, true = rf.exact_filtered(s["v"].X, s["v"].Q, s["bits"][f], k)
        r = rf.ann_recall(torch.from_numpy(ids), true)
        if r is not None:
            recalls.append(r)
    tracing.note(f"recall@10 by filter {recalls}")
    return {"qps": rec["passes"] * rec["nq"] / rec["elapsed_s"],
            "recall10": sum(recalls) / len(recalls) if recalls else 0.0}


def sample(ctx, f: int) -> torch.Tensor:
    """Filter f's checked queries: `check_per_filter` (at most the
    configuration's `check_sample`) drawn from the seed."""
    nq = ctx.state["v"].Q.shape[0]
    n = min(int(ctx.mix["check_per_filter"]),
            int(ctx.cfg["search"].get("check_sample", nq)), nq)
    g = torch.Generator().manual_seed((ctx.seed + 1 + f) & data.SEED_MASK)
    return torch.sort(torch.randperm(nq, generator=g)[:n]).values


def numbers(ctx, control: bool = False) -> dict:
    """The compared numbers of the served index and of the window's answers
    under each filter (for the control, the reference's at TF32 in their
    place) against the float32 references."""
    s, cfg = ctx.state, ctx.cfg
    v = s["v"]
    e = cfg["engine"]
    st = program.index_state(s["engine"], v.X)
    out = batch.index_numbers(cfg, st, control)
    kw = dict(top_t=e["top_t"], budget=e["rerank_budget"], k=cfg["search"]["k"])
    sets, filter_bad, short_rows = [], 0, 0
    for f, bits in enumerate(s["bits"]):
        sel = sample(ctx, f).to(v.Q.device)
        Q = v.Q[sel]
        ref = rf.search(st, Q, bits, **kw)
        if control:
            got = rf.search(st, Q, bits, prec="tf32", **kw)
            pairs = [(got.ids, got.scores, got.ids)]
        else:
            sel_np = sel.cpu().numpy()
            pairs = [(torch.from_numpy(a[0][sel_np]), torch.from_numpy(a[1][sel_np]),
                      torch.from_numpy(a[0])) for a in ctx.rec["answers"][f]]
        short = _short(ctx, f)
        bits_h = bits.cpu()
        for ids, sc, whole in pairs:
            sets.append(compare.answers(v.X, Q, ids, sc, ref.ids))
            w = whole.long().cpu()
            filter_bad += int((bits_h[w.clamp(min=0)] == 0)[w >= 0].sum())
            short_rows += int(short(w).sum())
        tracing.note(f"filter {ctx.mix['filters'][f]['name']}: population "
                     f"{_population(ctx, f)}, reference steps "
                     f"{torch.bincount(ref.steps).tolist()}")
    out.update(compare.worst(*sets))
    out.update(filter_bad=filter_bad, short_rows=short_rows)
    return out
