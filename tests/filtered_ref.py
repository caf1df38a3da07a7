"""Plain PyTorch reference of filtered search, float32 with TF32 off.

It imports neither JAX nor any module of `repro_torch`: the index comes in
as plain tensors (`Index`), and every route, score, dedup and rerank is
worked out here, one query at a time, with no tiles, kernels or batching.

- `exact_topk`: filtered exact top-k by inner product over the eligible
  rows alone.
- `search`: the filtered IVF-PQ search under the budget rule. A query
  probes its top_t partitions (flat: ⟨q, c⟩; tree: the top t_route super
  centroids, then the best of their children), takes every slot whose id
  the filter passes, scores it by its PQ code (the LUT sum plus the
  coarse ⟨q, c⟩, or exactly without a PQ stage), keeps each id's best
  score and counts the unique ids. While that count is below min(stage
  budget, the eligible ids the index holds) and the router can widen,
  it probes again one step up: flat doubles top_t (at most c); the tree
  doubles top_t and t_route (at most S). The stage budget is the rerank
  budget with PQ, else k. The answer is that of the last pass: the top
  `budget` ids by approximate score, reranked exactly, top k, -1 past
  the ids found.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

NEG_INF = float("-inf")


class Tree(NamedTuple):
    supers: torch.Tensor            # (S, d)
    children: torch.Tensor          # (S, cmax) partition ids, -1 padded
    child_centroids: torch.Tensor   # (S, cmax, d)
    t_route: int


class Index(NamedTuple):
    centroids: torch.Tensor                  # (c, d)
    part_ids: torch.Tensor                   # (c, cap) point ids, -1 for an empty slot
    part_codes: Optional[torch.Tensor]       # (c, cap, m) uint8, or None: no PQ stage
    pq_centers: Optional[torch.Tensor]       # (m, 16, d / m)
    rows: torch.Tensor                       # (n, d) vectors by point id
    tree: Optional[Tree] = None              # None: the flat route


class Answer(NamedTuple):
    ids: torch.Tensor       # (nq, k) int64, -1 past the ids found
    scores: torch.Tensor    # (nq, k) exact ⟨q, x⟩, -inf past them
    top_t: torch.Tensor     # (nq,) the probe width of each query's last pass
    steps: torch.Tensor     # (nq,) escalation steps each query took


def _f32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def top_first(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lower index."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def exact_topk(rows: torch.Tensor, Q: torch.Tensor, bits: torch.Tensor, k: int):
    """Filtered exact top-k of each query over the rows the (n,) bitmap
    passes → (ids (nq, k) int64, scores (nq, k)); -1 / -inf past the
    population."""
    _f32()
    ok = bits.reshape(-1)[:rows.shape[0]] > 0
    s = torch.where(ok[None, :], Q @ rows.T, NEG_INF)
    v, i = top_first(s, min(k, s.shape[1]))
    i = torch.where(torch.isfinite(v), i, -1)
    pad = k - i.shape[1]
    if pad > 0:
        i = torch.cat([i, i.new_full((i.shape[0], pad), -1)], 1)
        v = torch.cat([v, v.new_full((v.shape[0], pad), NEG_INF)], 1)
    return i, v


def _route(ix: Index, q: torch.Tensor, top_t: int, t_route: int):
    """One query's probed partitions, best first → (scores (t',), parts (t',))."""
    if ix.tree is None:
        return top_first(ix.centroids @ q, min(top_t, ix.centroids.shape[0]))
    tr = ix.tree
    _, sup = top_first(tr.supers @ q, t_route)
    ch = tr.children[sup].reshape(-1).long()                   # super rank, then slot
    s = (tr.child_centroids[sup].reshape(-1, q.shape[0]) @ q)
    s = torch.where(ch >= 0, s, NEG_INF)
    v, pos = top_first(s, min(top_t, s.shape[0]))
    keep = torch.isfinite(v)
    return v[keep], ch[pos][keep]


def _pass(ix: Index, q: torch.Tensor, bits: torch.Tensor, top_t: int, t_route: int,
          budget: int, k: int):
    """One pass → (ids (k,), exact scores (k,), unique eligible ids)."""
    psc, parts = _route(ix, q, top_t, t_route)
    slot_ids = ix.part_ids[parts].long()                           # (t, cap)
    ok = (slot_ids >= 0) & (bits[slot_ids.clamp(min=0)] > 0)
    pi, si = torch.nonzero(ok, as_tuple=True)
    pid = slot_ids[pi, si]
    if ix.part_codes is None:
        a = ix.rows[pid] @ q
    else:
        m, _, sub = ix.pq_centers.shape
        lut = torch.einsum("ms,mjs->mj", q.reshape(m, sub), ix.pq_centers)   # (m, 16)
        codes = ix.part_codes[parts[pi], si].long()                         # (e, m)
        a = lut[torch.arange(m)[None, :], codes].sum(1) + psc[pi]
    # each id once, at its best score
    o = torch.sort(a, descending=True, stable=True).indices
    o = o[torch.sort(pid[o], stable=True).indices]
    first = torch.ones(o.shape[0], dtype=torch.bool)
    first[1:] = pid[o][1:] != pid[o][:-1]
    uniq, a = pid[o][first], a[o][first]
    if ix.part_codes is not None:
        _, pos = top_first(a, min(budget, uniq.shape[0]))
        uniq = uniq[pos]
    exact = ix.rows[uniq] @ q
    v, pos = top_first(exact, min(k, exact.shape[0]))
    out_i = torch.full((k,), -1, dtype=torch.int64)
    out_v = torch.full((k,), NEG_INF)
    out_i[:v.shape[0]], out_v[:v.shape[0]] = uniq[pos], v
    return out_i, out_v, int(first.sum())


def population(ix: Index, bits: torch.Tensor) -> int:
    """The eligible ids the index holds."""
    held = ix.part_ids[ix.part_ids >= 0].long()
    return int(torch.unique(held[bits[held] > 0]).numel())


def search(ix: Index, Q: torch.Tensor, bits: torch.Tensor, *, top_t: int, k: int,
           budget: int) -> Answer:
    """The filtered search under the budget rule, one query at a time."""
    _f32()
    c = ix.centroids.shape[0]
    S = ix.tree.supers.shape[0] if ix.tree is not None else 0
    stage = budget if ix.part_codes is not None else k
    thresh = min(stage, population(ix, bits))
    out_i, out_v, out_t, out_s = [], [], [], []
    for q in Q:
        t = max(0, min(top_t, c))
        tr = max(1, min(ix.tree.t_route, S)) if ix.tree is not None else 0
        steps = 0
        while True:
            i, v, u = _pass(ix, q, bits, t, tr, budget, k)
            wider = t < c or (ix.tree is not None and tr < S)
            if min(u, stage) >= thresh or not wider:
                break
            t, tr, steps = min(2 * t, c), min(2 * tr, S), steps + 1
        out_i.append(i)
        out_v.append(v)
        out_t.append(t)
        out_s.append(steps)
    return Answer(torch.stack(out_i), torch.stack(out_v), torch.tensor(out_t),
                  torch.tensor(out_s))
