"""Least work of a cell's operations, worked out once a run from the
index's state and the queries (`roofline.py`'s rules, the reference's
route and candidates), and the kernel shares the per-layer readers report.

Results are kept on the run's context, so readers that share a count work
it out once.
"""
from __future__ import annotations

import torch

from annbench import program, roofline
from annbench.reference import search as ref


def _memo(ctx, key, fn):
    memo = ctx.__dict__.setdefault("memo", {})
    if key not in memo:
        memo[key] = fn()
    return memo[key]


def batch_pass(ctx) -> dict:
    """One pass of the batch cell's queries: {"pass": whole search,
    "probe": the probe scorer, "route": the tree route (None when flat)}."""
    def count():
        s, cfg = ctx.state, ctx.cfg
        v = s["v"]
        st = program.index_state(s["engine"], v.X)
        e = cfg["engine"]
        top_t, budget, k = e["top_t"], e["rerank_budget"], cfg["search"]["k"]
        nq, d = v.Q.shape
        c = st.centroids.shape[0]
        m = st.pq_centers.shape[0]
        ext = roofline.extents(st.part_ids)
        parts, rows, sups = [], [], []
        blk = ref.block_rows(st, top_t)
        for q0 in range(0, nq, blk):
            qb = v.Q[q0:q0 + blk]
            p, _, bi, _ = ref.candidates(st, qb, top_t, budget)
            parts.append(p)
            rows.append(bi.reshape(-1))
            if st.tree is not None:
                sups.append(ref.supers(st, qb))
        parts = torch.cat(parts)
        uniq = torch.unique(torch.cat(rows))
        n_rows = int((uniq >= 0).sum())
        if st.tree is None:
            route = roofline.flat_route(nq, c, d, top_t)
            tree = None
        else:
            S = st.tree.supers.shape[0]
            tree = route = roofline.tree_route(torch.cat(sups), st.tree.children, nq, S, d)
        return {"pass": roofline.search_pass(nq=nq, d=d, c=c, m=m, k=k, budget=budget,
                                             route=route, ext=ext, parts=parts,
                                             n_rerank_rows=n_rows),
                "probe": roofline.probe_scoring(ext, parts, m),
                "route": tree}
    return _memo(ctx, "batch_pass", count)


def kernel_share(ctx, match, work: roofline.Work, calls_of_work: float):
    """Share of the roofline of the traced slice's kernels that `match`
    accepts, doing `calls_of_work` times `work`; None where the slice ran
    none of them."""
    t = ctx.tr.device_s(match)
    if t <= 0 or calls_of_work <= 0:
        return None
    return roofline.share_pct(work.scaled(calls_of_work), t)


def idle_pct(ctx) -> float:
    return 100.0 * (1.0 - ctx.tr.busy_s() / ctx.tr.window_s)
