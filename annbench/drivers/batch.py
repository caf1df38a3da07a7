"""Closed-loop batch search (ann-benchmarks' batch mode).

Set-up makes the configuration's vectors from the seed, builds the index
through `AnnEngine`'s sharded build and warms the search at the window's
shape. The window: one client calls `AnnEngine.search_request` with all
queries, back to back, results on the host, until `seconds` have passed;
`qps` is every query answered over the whole time. `recall10` is the last
answers' recall@10 against exact inner-product neighbours.

Correctness: the index set-up built, as the engine serves it, is judged
against the benchmark's vectors (`compare.index`: every row's two
partitions and every slot's PQ code given the codebooks; with a tree
router, its tables, `reference/router.py`). Every distinct set of answers
the window returned is judged (`compare.answers`) against the reference
search over that index, on the queries of the configuration's
`check_sample` (all, or a sample drawn from the seed).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from annbench import compare, data, program, tracing
from annbench.reference import router as rr
from annbench.reference import search as ref


def setup(ctx):
    cfg = ctx.cfg
    v = data.make(cfg["data"], ctx.seed, ctx.device)
    tracing.note("vectors made")
    _, SearchParams, _, _ = program.api()
    engine = program.engine_over(cfg, program.build_index(cfg, v.X, ctx.seed, ctx.device))
    tracing.note("index built")
    Qn = v.Q.cpu().numpy()
    params = SearchParams(k=cfg["search"]["k"])
    for _ in range(2):                       # the window's shapes, warmed
        engine.search_request(Qn, params)
    tracing.note("search warmed")
    return {"v": v, "engine": engine, "params": params, "Qn": Qn}


def _loop(ctx, seconds: float, keep: bool) -> dict:
    s = ctx.state
    engine, params, Qn = s["engine"], s["params"], s["Qn"]
    answers, passes, pass_s = [], 0, []
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        with tracing.span("search_request"):
            r = engine.search_request(Qn, params)
        pass_s.append(time.perf_counter() - t)
        passes += 1
        if keep:
            for a in answers:
                if np.array_equal(a[0], r.ids) and np.array_equal(a[1], r.scores):
                    a[2] += 1
                    break
            else:
                answers.append([r.ids, r.scores, 1])
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    q = sorted(pass_s)
    tracing.note(f"{passes} passes, seconds a pass: min {q[0]:.5f} p10 {q[len(q) // 10]:.5f} "
                 f"median {q[len(q) // 2]:.5f} p90 {q[9 * len(q) // 10]:.5f} max {q[-1]:.5f}")
    nq = Qn.shape[0]
    failed = sum(int((a[0] < 0).any(1).sum()) * a[2] for a in answers)
    return {"passes": passes, "elapsed_s": elapsed, "pass_s": pass_s, "nq": nq,
            "answers": answers, "attempted": passes * nq, "failed": failed}


def window(ctx, seconds: float) -> dict:
    return _loop(ctx, seconds, keep=True)


def traced(ctx, seconds: float) -> dict:
    return _loop(ctx, seconds, keep=False)


def end_to_end(ctx) -> dict:
    rec, v = ctx.rec, ctx.state["v"]
    k = ctx.cfg["search"]["k"]
    _, true = ref.exact_topk(v.Q, v.X, k)
    hits = 0
    for ids, _, count in rec["answers"]:
        got = torch.from_numpy(ids).to(true.device).long()
        hits += int((true[:, :, None] == got[:, None, :]).any(2).sum()) * count
    return {"qps": rec["passes"] * rec["nq"] / rec["elapsed_s"],
            "recall10": hits / (rec["passes"] * rec["nq"] * k)}


def sample(ctx) -> torch.Tensor:
    """The checked queries: all, or `check_sample` drawn from the seed."""
    nq = ctx.state["v"].Q.shape[0]
    n = min(int(ctx.cfg["search"].get("check_sample", nq)), nq)
    if n == nq:
        return torch.arange(nq)
    g = torch.Generator().manual_seed(ctx.seed & ((1 << 63) - 1))
    return torch.sort(torch.randperm(nq, generator=g)[:n]).values


def index_numbers(cfg: dict, st: ref.IndexState, control: bool) -> dict:
    """The served index's numbers (for the control, the reference's TF32
    assignments, codes and router children over the same codebooks)."""
    ix = cfg["index"]
    X, lam = st.rows, float(ix["lam"])
    if control:
        out = compare.index_control(X, st.centroids, st.pq_centers, lam)
    else:
        point, part, slot = compare.slots(st.part_ids)
        codes = st.part_codes.reshape(-1, st.part_codes.shape[-1])[slot]
        out = compare.index(X, st.centroids, st.pq_centers, point, part, codes, lam,
                            1 + int(ix["n_spills"]))
    if st.tree is not None:
        kw = ix["router_kw"]
        live = (st.part_ids >= 0).any(1)
        out.update(rr.numbers(st.centroids, live, st.tree, int(kw["n_super"]),
                              int(kw["t_route"]), control))
    return out


def numbers(ctx, control: bool = False) -> dict:
    """The compared numbers of the served index and of the window's answers
    (or, for the control, of the reference's at TF32 in their place)
    against the float32 references."""
    s, cfg = ctx.state, ctx.cfg
    v = s["v"]
    e = cfg["engine"]
    st = program.index_state(s["engine"], v.X)
    out = index_numbers(cfg, st, control)
    sel = sample(ctx).to(v.Q.device)
    Q = v.Q[sel]
    kw = dict(top_t=e["top_t"], budget=e["rerank_budget"], k=cfg["search"]["k"])
    ref_ids, _ = ref.ann_search(st, Q, **kw)
    if control:
        sets = [ref.ann_search(st, Q, prec="tf32", **kw)]
    else:
        sel_np = sel.cpu().numpy()
        sets = [(torch.from_numpy(a[0][sel_np]), torch.from_numpy(a[1][sel_np]))
                for a in ctx.rec["answers"]]
    out.update(compare.worst(*(compare.answers(v.X, Q, i, sc, ref_ids) for i, sc in sets)))
    return out
