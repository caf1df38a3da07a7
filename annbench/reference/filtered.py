"""Plain reference of filtered search: exact neighbours among the rows a
filter passes, and the filtered IVF-PQ search under the budget rule, over
an index's state.

`search` follows the index the program built (codebook, PQ codebook,
partition slots, router tables) and works out the rest again. Each pass
routes a query as `search.route` does (flat, or the two-level tree at the
pass's t_route), takes every slot of its probed partitions whose id the
filter passes, scores it by its PQ code plus the coarse ⟨q, c⟩, keeps each
id's best score and counts the unique ids. A query whose count is below
min(rerank budget, the eligible ids the index holds) probes again one
escalation step up while the router can widen (flat: doubled top_t, at
most c; tree: doubled top_t and t_route, at most S). Its answer is that
of its last pass: the top `budget` ids by approximate score, reranked
exactly, top k, -1 past the ids found. Every product runs at `prec`.

The candidates of a pass are the eligible slots alone, listed query by
query, so the work follows the filter, not the window.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from annbench.reference.precision import operand, rowdot
from annbench.reference.search import NEG_INF, WINDOW, IndexState, exact_topk, route


class Answer(NamedTuple):
    ids: torch.Tensor       # (nq, k) int64, -1 past the ids found
    scores: torch.Tensor    # (nq, k) exact scores at the search's precision
    top_t: torch.Tensor     # (nq,) the probe width of each query's last pass
    steps: torch.Tensor     # (nq,) escalation steps each query took


def exact_filtered(rows: torch.Tensor, Q: torch.Tensor, bits: torch.Tensor, k: int):
    """Exact inner-product top-k among the rows the (n,) bitmap passes →
    (scores (nq, k), ids (nq, k) int64, -1 past the population)."""
    keep = torch.nonzero(bits[:rows.shape[0]] > 0)[:, 0]
    if keep.numel() == 0:
        return (torch.full((Q.shape[0], k), NEG_INF, device=Q.device),
                torch.full((Q.shape[0], k), -1, dtype=torch.int64, device=Q.device))
    v, i = exact_topk(Q, rows[keep], min(k, keep.numel()))
    i = torch.where(torch.isfinite(v), keep[i.clamp(min=0)], -1)
    pad = k - i.shape[1]
    if pad > 0:
        i = torch.cat([i, i.new_full((i.shape[0], pad), -1)], 1)
        v = torch.cat([v, v.new_full((v.shape[0], pad), NEG_INF)], 1)
    return v, i


def population(st: IndexState, bits: torch.Tensor) -> int:
    """The eligible ids the index holds."""
    held = st.part_ids[st.part_ids >= 0].long()
    return int(torch.unique(held[bits[held] > 0]).numel())


def _first_of_runs(key: torch.Tensor) -> torch.Tensor:
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    return first


def _ranked(score: torch.Tensor, group: torch.Tensor) -> torch.Tensor:
    """Order by group ascending, then score descending; ties by position."""
    o = torch.sort(score, descending=True, stable=True).indices
    return o[torch.sort(group[o], stable=True).indices]


def _pass(st: IndexState, Q: torch.Tensor, bits: torch.Tensor, top_t: int, budget: int,
          k: int, prec: str):
    """One pass of a block of queries → (ids (b, k), scores (b, k), unique
    eligible ids (b,))."""
    b, n = Q.shape[0], st.rows.shape[0]
    psc, parts = route(st, Q, top_t, prec)
    slot_ids = st.part_ids[parts].long()                          # (b, t, cap)
    ok = (slot_ids >= 0) & torch.isfinite(psc)[:, :, None]
    ok &= bits[slot_ids.clamp(min=0)] > 0
    qi, pi, si = torch.nonzero(ok, as_tuple=True)                  # the eligible slots
    ids = slot_ids[qi, pi, si]
    m, _, s = st.pq_centers.shape
    lut = torch.einsum("bms,mjs->bmj", operand(Q.reshape(b, m, s), prec),
                       operand(st.pq_centers, prec))               # (b, m, 16)
    codes = st.part_codes[parts[qi, pi], si].long()                # (e, m)
    approx = psc[qi, pi].clone()
    for j in range(m):
        approx += lut[qi, j, codes[:, j]]
    # each (query, id) once, at its best score
    key = qi * n + ids
    o = torch.sort(approx, descending=True, stable=True).indices
    o = o[torch.sort(key[o], stable=True).indices]
    o = o[_first_of_runs(key[o])]
    qi, ids, approx = qi[o], ids[o], approx[o]
    uniq = torch.bincount(qi, minlength=b)
    # the top `budget` of each query by approximate score, reranked exactly
    o = _ranked(approx, qi)
    qi, ids = qi[o], ids[o]
    start = torch.cumsum(uniq, 0) - uniq
    keep = torch.arange(qi.numel(), device=qi.device) - start[qi] < budget
    qi, ids = qi[keep], ids[keep]
    ex = rowdot(st.rows[ids], Q[qi], prec)
    o = _ranked(ex, qi)
    qi, ids, ex = qi[o], ids[o], ex[o]
    cnt = torch.bincount(qi, minlength=b)
    rank = torch.arange(qi.numel(), device=qi.device) - (torch.cumsum(cnt, 0) - cnt)[qi]
    top = rank < k
    out_i = torch.full((b, k), -1, dtype=torch.int64, device=Q.device)
    out_v = torch.full((b, k), NEG_INF, device=Q.device)
    out_i[qi[top], rank[top]] = ids[top]
    out_v[qi[top], rank[top]] = ex[top]
    return out_i, out_v, uniq


def search(st: IndexState, Q: torch.Tensor, bits: torch.Tensor, *, top_t: int,
           budget: int, k: int, prec: str = "f32") -> Answer:
    """The filtered search under the budget rule → `Answer`. bits: (n,)
    bitmap over point ids (1 = eligible), on the index's device."""
    nq, c = Q.shape[0], st.centroids.shape[0]
    bits = bits.reshape(-1)
    thresh = min(budget, population(st, bits))
    tree = st.tree
    S = tree.supers.shape[0] if tree is not None else 0
    t = max(0, min(top_t, c))
    tr = max(1, min(tree.t_route, S)) if tree is not None else 0
    out_i = torch.full((nq, k), -1, dtype=torch.int64, device=Q.device)
    out_v = torch.full((nq, k), NEG_INF, device=Q.device)
    out_t = torch.zeros(nq, dtype=torch.int64)
    steps = torch.zeros(nq, dtype=torch.int64)
    active = torch.arange(nq, device=Q.device)
    while active.numel():
        state = st if tree is None else st._replace(tree=tree._replace(t_route=tr))
        block = max(1, WINDOW // max(1, t * st.part_ids.shape[1]))
        uniq = []
        for q0 in range(0, active.numel(), block):
            rows = active[q0:q0 + block]
            i, v, u = _pass(state, Q[rows], bits, t, budget, k, prec)
            out_i[rows], out_v[rows] = i, v
            uniq.append(u)
        out_t[active.cpu()] = t
        wider = t < c or (tree is not None and tr < S)
        if not wider:
            break
        active = active[torch.cat(uniq) < thresh]
        steps[active.cpu()] += 1
        t, tr = min(2 * t, c), min(2 * tr, S)
    return Answer(out_i, out_v, out_t, steps)


def ann_recall(ids: torch.Tensor, true: torch.Tensor) -> float:
    """Recall of (nq, k) answers against (nq, k) exact ids (-1 ignored):
    found over expected, or None where nothing is expected."""
    valid = true >= 0
    want = int(valid.sum())
    if want == 0:
        return None
    hit = (true[:, :, None] == ids.to(true.device).long()[:, None, :]).any(2) & valid
    return float(hit.sum()) / want
