"""Plain references of a search: exact inner-product neighbours, and the
IVF-PQ search with spilled assignments over an index's state.

`ann_search` follows the index the program built (codebook, residual PQ
codebook, partition slots, router tables) and works out the rest again:
route (flat Q·Cᵀ, or the two-level tree), the candidate window of every
live slot of the probed partitions, PQ LUT scores plus the coarse ⟨q, c⟩
term, dedup by best score per id, the top `budget`, exact rerank against
the benchmark's own vectors, top k. Ties go to the lower index. Every
product runs at `prec` ("f32", or the control's "tf32"). The index itself
is judged apart (`compare.index`, `reference/router.py`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from annbench.reference.precision import mm, operand, rowdot

NEG_INF = float("-inf")
WINDOW = 1 << 24        # candidate slots a block of the reference search holds


class Tree(NamedTuple):
    supers: torch.Tensor           # (S, d) f32
    children: torch.Tensor         # (S, cmax) int32 partition ids, -1 padded
    child_centroids: torch.Tensor  # (S, cmax, d) f32
    t_route: int


class IndexState(NamedTuple):
    centroids: torch.Tensor              # (c, d) f32
    pq_centers: torch.Tensor             # (m, 16, s) f32
    part_ids: torch.Tensor               # (c, cap) int32, -1 for an empty slot
    part_codes: torch.Tensor             # (c, cap, m) uint8
    rows: torch.Tensor                   # (N, d) f32 vectors by point id (the benchmark's own)
    tree: Optional[Tree] = None          # None → flat route


def top_first(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lower index."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def exact_topk(Q: torch.Tensor, X: torch.Tensor, k: int, prec: str = "f32",
               block_q: int = 1024, block_x: int = 262_144):
    """Exact inner-product top-k of each query over all rows of X →
    (scores (nq, k), ids (nq, k) int64)."""
    out_v, out_i = [], []
    for q0 in range(0, Q.shape[0], block_q):
        qb = Q[q0:q0 + block_q]
        bv = torch.full((qb.shape[0], k), NEG_INF, device=Q.device)
        bi = torch.full((qb.shape[0], k), -1, dtype=torch.int64, device=Q.device)
        for x0 in range(0, X.shape[0], block_x):
            s = mm(qb, X[x0:x0 + block_x].T, prec)
            v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
            bv, pos = top_first(torch.cat([bv, v], 1), k)
            bi = torch.gather(torch.cat([bi, i + x0], 1), 1, pos)
        out_v.append(bv)
        out_i.append(bi)
    return torch.cat(out_v), torch.cat(out_i)


def exact_scores(rows: torch.Tensor, Q: torch.Tensor, ids: torch.Tensor,
                 prec: str = "f32") -> torch.Tensor:
    """⟨q, rows[id]⟩ for each (nq, k) id; -inf where the id is out of range."""
    ok = (ids >= 0) & (ids < rows.shape[0])
    s = rowdot(rows[ids.clamp(0, rows.shape[0] - 1).long()], Q[:, None, :], prec)
    return torch.where(ok, s, NEG_INF)


def supers(st: IndexState, Q: torch.Tensor, prec: str = "f32") -> torch.Tensor:
    """The tree's probed super centroids (b, t_route) int64."""
    tr = st.tree
    return top_first(mm(Q, tr.supers.T, prec), min(tr.t_route, tr.supers.shape[0]))[1]


def route(st: IndexState, Q: torch.Tensor, top_t: int, prec: str = "f32"):
    """Probed partitions → (coarse scores (b, t), partitions (b, t) int64);
    a probe slot with no partition scores -inf."""
    live = (st.part_ids >= 0).any(1)
    if st.tree is None:
        s = mm(Q, st.centroids.T, prec)
        s = torch.where(live[None, :], s, NEG_INF)
        return top_first(s, min(top_t, s.shape[1]))
    tr = st.tree
    sup = supers(st, Q, prec)
    ch = tr.children[sup].long()                                   # (b, tr, cmax)
    ok = (ch >= 0) & live[ch.clamp(min=0)]
    cs = rowdot(tr.child_centroids[sup], Q[:, None, None, :], prec)
    cs = torch.where(ok, cs, NEG_INF).reshape(Q.shape[0], -1)
    v, pos = top_first(cs, min(top_t, cs.shape[1]))
    return v, torch.gather(ch.reshape(Q.shape[0], -1), 1, pos).clamp(min=0)


def _window(st: IndexState, Q, psc, parts, prec):
    """(ids (b, W), PQ + coarse scores (b, W)) over every slot of the
    probed partitions; dead or unprobed slots carry -inf."""
    b = Q.shape[0]
    ids = st.part_ids[parts].reshape(b, -1).long()               # (b, t·cap)
    cap = st.part_ids.shape[1]
    ok = (ids >= 0) & torch.isfinite(psc).repeat_interleave(cap, 1)
    m, _, s = st.pq_centers.shape
    lut = torch.einsum("bms,mjs->bmj", operand(Q.reshape(b, m, s), prec),
                       operand(st.pq_centers, prec))              # (b, m, 16)
    codes = st.part_codes[parts].reshape(b, -1, m)
    approx = psc.repeat_interleave(cap, 1).clone()
    approx = torch.where(ok, approx, 0.0)
    for k in range(m):
        approx += torch.gather(lut[:, k, :], 1, codes[:, :, k].long())
    return torch.where(ok, ids, -1), torch.where(ok, approx, NEG_INF)


def _dedup_top(ids, approx, budget):
    """Best score per id, then the top `budget` ids → (ids, scores), -1 /
    -inf where the window had fewer."""
    v, o = torch.sort(approx, dim=1, descending=True, stable=True)
    i = torch.gather(ids, 1, o)
    i2, o2 = torch.sort(i, dim=1, stable=True)                   # runs of one id, best first
    v2 = torch.gather(v, 1, o2)
    first = torch.ones_like(i2, dtype=torch.bool)
    first[:, 1:] = i2[:, 1:] != i2[:, :-1]
    v2 = torch.where(first & (i2 >= 0), v2, NEG_INF)
    bv, pos = top_first(v2, min(budget, v2.shape[1]))
    bi = torch.gather(i2, 1, pos)
    return torch.where(torch.isfinite(bv), bi, -1), bv


def block_rows(st: IndexState, top_t: int) -> int:
    """Queries a block, so that a block's window holds about WINDOW slots."""
    return max(1, WINDOW // (2 * top_t * st.part_ids.shape[1]))


def candidates(st: IndexState, Q: torch.Tensor, top_t: int, budget: int,
               prec: str = "f32"):
    """Route, window, dedup → (probed partitions (b, t), probe scores
    (b, t), the top `budget` ids (b, budget) with -1 past the window's
    unique ids, and their PQ scores)."""
    psc, parts = route(st, Q, top_t, prec)
    ids, approx = _window(st, Q, psc, parts, prec)
    bi, bv = _dedup_top(ids, approx, budget)
    return parts, psc, bi, bv


def ann_search(st: IndexState, Q: torch.Tensor, *, top_t: int, budget: int, k: int,
               prec: str = "f32"):
    """The reference IVF-PQ search → (ids (nq, k) int64, -1 where fewer
    than k; exact scores (nq, k) at `prec`)."""
    ids, vals = [], []
    block = block_rows(st, top_t)
    for q0 in range(0, Q.shape[0], block):
        qb = Q[q0:q0 + block]
        _, _, bi, _ = candidates(st, qb, top_t, budget, prec)
        ex = torch.where(bi >= 0, rowdot(st.rows[bi.clamp(min=0)], qb[:, None, :], prec),
                         NEG_INF)
        fv, pos = top_first(ex, min(k, ex.shape[1]))
        fi = torch.where(torch.isfinite(fv), torch.gather(bi, 1, pos), -1)
        if fi.shape[1] < k:
            pad = k - fi.shape[1]
            fi = torch.cat([fi, fi.new_full((fi.shape[0], pad), -1)], 1)
            fv = torch.cat([fv, fv.new_full((fv.shape[0], pad), NEG_INF)], 1)
        ids.append(fi)
        vals.append(fv)
    return torch.cat(ids), torch.cat(vals)
