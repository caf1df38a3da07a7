"""Candidate-local ANN search over a spilled IVF index (PyTorch port of
`repro/core/search.py`): the fixed-budget engine (`search_jit`,
`search_jit_batched`) and the ragged host engine (`search_numpy`, at the
end of this module).

Pipeline per query tile: router probe top-t (flat: one matmul + top-t;
tree: the two-level `tree_route` kernel) → each query's own (t·pmax)
candidate window of the padded layout: its PQ LUT scores plus the coarse
⟨q, c⟩ term are read by probe id from the packed codes and its top
multiplicity·rerank_budget candidate slots kept with their ids
(`pq_score_probes_select`, the CUDA kernel on the card, so the window is
neither gathered nor written) → dedup-by-max over them → top
rerank_budget → exact rerank → top final_k. No intermediate scales
with the database size n. The rerank rows are f32 or, for an index built
with `rerank="int8"`, int8 codes with a scale a row, held so on the
device: a candidate then scores ⟨q, x₈⟩ summed in f32 times its scale,
and the rerank and its top final_k are one launch (`int8_rerank`, the
CUDA kernel on the card). Each tile of `search_jit_batched` is the span
"search.tile", its stages its children "search.route", "search.lut",
"search.score" (counting the rows it `selected`), "search.dedup",
"search.rerank" (counting the valid candidates, `rows`, and the bytes
of rerank rows and scales it read, `row_bytes`, over a tile's queries)
and, when a filtered search escalates, "search.escalate"
(`repro_torch.spans`). Without PQ, or where the kept slots outnumber
what the scorer holds on chip, the window's ids are gathered
("search.gather") and the window is scored whole.

A filter is an (n,) uint8 bitmap over point ids. With `escalate` True or
False the scorer reads it for the slots it keeps, and True adds a second
pass one router-escalation step up for rows whose first-pass window was
thin. With
`escalate="budget"` (ESCALATE_BUDGET) the index is first cut to the
filter's eligible slots (`filtered_pack`), so no ineligible slot is
scored, deduped or reranked, and each tile takes its thin rows, and only
those, up the router's escalation steps until each has as many unique
eligible candidates as the stage budget (capped at the filter's
population) or the router is exhausted: the host engine's rule, on the
device, tile by tile. Where the steps are prefixes of one route (the
flat router) one count settles each thin row's step and one pass runs a
step present; else the rows walk up a pass a step.

The host engine gathers every probed partition's CSR segment for the
whole batch, dedups per (query, id) by sorts and reranks; it runs in
torch on the index's device, query chunks at a time.

Names follow the JAX package so each function's counterpart is easy to
find; there is no jit here, PyTorch runs eagerly.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.ivf import IVFIndex
from repro_torch.core.router import FlatRouter, check_query_dim
from repro_torch.kernels.int8_rerank import int8_rerank
from repro_torch.kernels.pq_score import pq_score_probes, pq_score_probes_select, select_fits
from repro_torch.kernels.ref import int8_scores_ref
from repro_torch.quant.int8 import Int8Data, rerank_table
from repro_torch.quant.pq import PQCodebook, pq_lut
from repro_torch.spans import count, recording, span
from repro_torch.utils import as_tensor, topk_first

_NEG_INF = float("-inf")
ESCALATE_BUDGET = "budget"      # `escalate`: walk thin rows to the stage budget


class PackedIVF(NamedTuple):
    """Dense, padded IVF layout for the fixed-budget search.

    part_ids:   (c, pmax) int32 point ids, -1 padded; a -1 may also sit
                inside a partition's extent (a removed point)
    part_codes: (c, pmax, m) uint8 PQ codes (zeros where padded), or None
    sizes:      (c,) int32 live ids per partition (the JAX package's meaning)
    extent:     (c,) int32 slot extent per partition: its last slot holding
                an id >= 0, plus one. The probe scorer reads the slots below
                it, and the search masks what it scored by id.
    rerank:     (n, d) f32 rows, or an Int8Data: (n, d) int8 codes and (n,)
                f32 scales
    router:     the index's probe router (core/router.py); None → flat
    """
    centroids: torch.Tensor
    part_ids: torch.Tensor
    part_codes: Optional[torch.Tensor]
    sizes: torch.Tensor
    extent: torch.Tensor
    pq: Optional[PQCodebook]
    rerank: Union[torch.Tensor, Int8Data]
    router: Optional[object] = None


def _exact_scores(rerank: Union[torch.Tensor, Int8Data], Q: torch.Tensor,
                 ids: torch.Tensor) -> torch.Tensor:
    """Q (nq, d), ids (nq, w) ≥ -1 → ⟨q, row⟩ (nq, w), a -1 scored as row
    0: f32 rows by one product, int8 rows by `int8_scores_ref`."""
    rows = ids.clamp(min=0).to(torch.int64)
    if isinstance(rerank, Int8Data):
        return int8_scores_ref(Q, rerank.q, rerank.scale, rows)
    return torch.einsum("qwd,qd->qw", rerank[rows], Q)


def slot_extent(part_ids: torch.Tensor) -> torch.Tensor:
    """Per partition row (the last axis holds its slots): the last slot
    holding an id >= 0, plus one (0 when empty) — `PackedIVF.extent`."""
    slot = torch.arange(1, part_ids.shape[-1] + 1, dtype=torch.int32,
                        device=part_ids.device)
    return torch.where(part_ids >= 0, slot, 0).amax(dim=-1).to(torch.int32)


def pack_ivf(index: IVFIndex, pmax: Optional[int] = None) -> PackedIVF:
    """Pack an IVFIndex into the dense padded layout (on its device).

    pmax caps the partition width (default: the largest partition); an
    explicit 0 packs all -1 sentinels at width 1. The rerank table is the
    index's own: its f32 rows, or its int8 codes and scales. Every
    partition's slots are live up to its size, so its extent is its size.
    """
    c = index.n_partitions
    dev = index.point_ids.device
    sizes = index.partition_sizes()
    if pmax is None:
        pmax = int(sizes.max()) if sizes.numel() else 0
    pmax = int(pmax)
    width = max(pmax, 1)
    m = index.codes.shape[1] if index.codes is not None else 0
    ids = torch.full((c, width), -1, dtype=torch.int32, device=dev)
    codes = (torch.zeros((c, width, m), dtype=torch.uint8, device=dev)
             if m else None)
    part = torch.repeat_interleave(torch.arange(c, device=dev), sizes)
    pos = (torch.arange(index.n_assignments, device=dev)
           - torch.repeat_interleave(index.starts[:-1], sizes))
    keep = pos < pmax
    ids[part[keep], pos[keep]] = index.point_ids[keep]
    if m:
        codes[part[keep], pos[keep]] = index.codes[keep]
    rerank = index.rerank_f32 if index.rerank_f32 is not None else index.rerank_int8
    sizes = sizes.clamp(max=pmax).to(torch.int32)
    return PackedIVF(index.centroids, ids, codes, sizes, sizes, index.pq,
                     rerank, index.router)


def dedup_topk_window(ids: torch.Tensor, scores: torch.Tensor, k: int,
                      multiplicity: int = 2):
    """Candidate-local dedup-by-max + top-k over the last axis.

    1. top multiplicity·k of the raw window (`_window_top`) — a point
       holds at most `multiplicity` window slots, so this keeps every copy
       that could reach the deduped top-k;
    2. `dedup_ranked` over that small set.

    Returns (ids (..., k) int32, scores (..., k)); k is clamped to the
    window length.
    """
    return dedup_ranked(*_window_top(ids, scores, min(multiplicity * k, ids.shape[-1])), k)


def _window_top(ids: torch.Tensor, scores: torch.Tensor, raw: int):
    """A window's top `raw` slots by score, descending → (ids, scores)."""
    if raw < ids.shape[-1]:
        scores, pos = torch.topk(scores, raw, dim=-1)
    else:
        scores, pos = topk_first(scores, raw)
    return torch.gather(ids, -1, pos), scores


def dedup_ranked(ids: torch.Tensor, scores: torch.Tensor, k: int):
    """Dedup-by-max + top-k of a window's top slots, ordered by score
    descending (the first stage of `dedup_topk_window`, or the selecting
    probe scorer's output): order them by (id asc, score desc), so the
    first slot of each run of equal ids carries the id's best score; the
    other slots and -1 padding become -inf before the final top-k.

    Returns (ids (..., k) int32, scores (..., k)); k is clamped to the
    set's length.
    """
    ids_s, pos = torch.sort(ids, dim=-1, stable=True)    # scores stay desc
    scores_s = torch.gather(scores, -1, pos)
    first = torch.ones_like(ids_s, dtype=torch.bool)
    first[..., 1:] = ids_s[..., 1:] != ids_s[..., :-1]
    scores_s = torch.where(first & (ids_s >= 0), scores_s, _NEG_INF)
    v, pos = topk_first(scores_s, min(k, ids.shape[-1]))
    return torch.gather(ids_s, -1, pos).to(torch.int32), v


def _pad_topk(ids: torch.Tensor, vals: torch.Tensor, k: int):
    """Pad (..., k') top-k outputs to width k with -1 ids / -inf scores."""
    short = k - ids.shape[-1]
    if short <= 0:
        return ids, vals
    pad = ids.shape[:-1] + (short,)
    return (torch.cat([ids, ids.new_full(pad, -1)], -1),
            torch.cat([vals, vals.new_full(pad, _NEG_INF)], -1))


def _search_pass(packed: PackedIVF, Q: torch.Tensor, router, top_t: int,
                 final_k: int, rerank_budget: int, multiplicity: int = 2,
                 filter: Optional[torch.Tensor] = None, route=None,
                 survivors: bool = False, rows: Optional[int] = None):
    """One fixed-top_t candidate-local pass → (ids, scores (nq, final_k),
    surviving).

    Every width derives from the probe output, which a tree router may
    return narrower than top_t. With a filter, filtered candidates become
    the -1 padding sentinel before dedup, and `surviving` (else None,
    unless `survivors`) counts the unique surviving candidates, capped at
    the stage budget (rerank_budget with PQ, else final_k): the escalation
    signal. route: the router's (scores, parts) when already taken.
    rows: the queries among Q's rows, the first ones (None: all), over
    which the rerank counts what it read.

    With PQ the scorer's selecting form hands the dedup each query's top
    multiplicity·rerank_budget slots of its (t·pmax) window, ids and
    scores, where it holds that many on chip (`select_fits`, a matter of
    shape); the window is then never gathered, masked or written. Else
    the window form scores the window and the dedup takes its top.
    """
    if route is None:
        with span("search.route"):
            route = router.route(Q, top_t)
    psc, parts = route                                  # (nq, t)
    survivors = survivors or filter is not None
    nq, t = parts.shape
    pmax = packed.part_ids.shape[1]
    keep = min(multiplicity * rerank_budget, t * pmax)
    codes = packed.part_codes
    select = codes is not None and select_fits(keep, codes.shape[2])
    if not select:
        with span("search.gather"):
            ids = packed.part_ids[parts].reshape(nq, t * pmax)
            if filter is not None:     # from here on, ids >= 0 marks the valid slots
                ids = torch.where(filter[ids.clamp(min=0).to(torch.int64)] > 0, ids, -1)
    surviving = None
    if codes is None:
        # no PQ stage: exact-score the whole window; rerank_budget unused
        with span("search.score"):
            exact = _exact_scores(packed.rerank, Q, ids)
            exact = torch.where(ids >= 0, exact, _NEG_INF)
        with span("search.dedup"):
            di, dv = _pad_topk(*dedup_topk_window(ids, exact, final_k, multiplicity),
                               final_k)
            if survivors:
                surviving = torch.isfinite(dv).sum(-1)
        return di, dv, surviving
    with span("search.lut"):
        luts = pq_lut(packed.pq, Q)                               # (nq, m, 16)
    if select:
        # PQ score + ⟨q, c⟩ of each candidate slot, its top `keep` kept on chip
        with span("search.score", selected=nq):
            ci, cv = pq_score_probes_select(luts, codes, packed.extent, parts, psc,
                                            packed.part_ids, keep, filter)
    else:
        # PQ score + ⟨q, c⟩ up to each partition's extent, then masked by id
        # (in place: the scorer's output is this pass's own)
        with span("search.score"):
            approx = pq_score_probes(luts, codes, packed.extent, parts, psc)
            approx = approx.masked_fill_(ids < 0, _NEG_INF)
    with span("search.dedup"):
        if not select:
            ci, cv = _window_top(ids, approx, keep)
        bi, bv = dedup_ranked(ci, cv, rerank_budget)
        if survivors:
            surviving = torch.isfinite(bv).sum(-1)
    with span("search.rerank") as rr:
        if isinstance(packed.rerank, Int8Data):
            fi, fv = int8_rerank(Q, packed.rerank, bi, bv, final_k)
        else:
            exact = torch.einsum("qbd,qd->qb",
                                 packed.rerank[bi.clamp(min=0).to(torch.int64)], Q)
            exact = torch.where(torch.isfinite(bv), exact, _NEG_INF)
            fv, fpos = topk_first(exact, min(final_k, exact.shape[-1]))
            fi, fv = _pad_topk(torch.gather(bi, -1, fpos), fv, final_k)
        if recording():
            _count_rerank(rr, packed.rerank, bv[:rows])
    return fi, fv, surviving


def _count_rerank(sp, rerank, bv: torch.Tensor) -> None:
    """The rerank's counts over the queries' rows of its (·, budget) PQ
    scores bv: `rows`, the valid (finite) candidates, and `row_bytes`, the
    rerank rows and scales read: d + 4 bytes a valid candidate from int8
    rows (the kernel reads no other), 4d a slot from f32 rows (the gather
    reads every slot's row)."""
    valid = torch.isfinite(bv)
    d = rerank_table(rerank).shape[1]
    if isinstance(rerank, Int8Data):
        sp.count(rows=valid, row_bytes=valid.sum() * (d + 4))
    else:
        sp.count(rows=valid, row_bytes=bv.numel() * 4 * d)


def _search_block(packed: PackedIVF, Q: torch.Tensor, router, top_t: int, final_k: int,
                  rerank_budget: int, multiplicity: int = 2,
                  filter: Optional[torch.Tensor] = None, escalate: bool = False,
                  rows: Optional[int] = None):
    """One `_search_pass`, plus, on the filtered path only, a second pass
    one router-escalation step up (flat: doubled top_t; tree: doubled top_t
    and t_route) whose rows replace the first pass's where its surviving
    window was thinner than the stage budget. router and top_t: the
    call's, resolved and clamped once (`search_jit_batched`); rows: the
    queries among Q's rows, the first ones (None: all)."""
    ids1, vals1, surv1 = _search_pass(packed, Q, router, top_t, final_k,
                                      rerank_budget, multiplicity, filter, rows=rows)
    if filter is None or not escalate or not router.can_escalate(top_t):
        return ids1, vals1
    thresh = rerank_budget if packed.part_codes is not None else final_k
    with span("search.escalate", rows=Q.shape[0]) as esc:
        r2, t2 = router.escalated(top_t)
        ids2, vals2, _ = _search_pass(packed, Q, r2, t2, final_k, rerank_budget,
                                      multiplicity, filter, rows=rows)
        need = (surv1 < thresh)[:, None]
        esc.count(kept=need)
        return torch.where(need, ids2, ids1), torch.where(need, vals2, vals1)


class _Subset(NamedTuple):
    """A filtered search's index, cut once a call (`_subset`)."""
    packed: PackedIVF        # the eligible slots alone (`filtered_pack`)
    extent: torch.Tensor     # (c,) the whole index's slot extents
    thresh: torch.Tensor     # 0-dim: min(stage budget, eligible population)


def filtered_pack(packed: PackedIVF, bits: torch.Tensor) -> Tuple[PackedIVF, torch.Tensor]:
    """The packed index cut to a filter's eligible slots → (packed,
    population).

    Each partition keeps the slots whose id the (n,) uint8 bitmap passes,
    in slot order, at the left of a row as wide as the most any partition
    keeps (at least 1); its size and extent are that count. Every slot of
    the result is eligible, so a search over it scores, dedups and reranks
    none that is not. population: the eligible ids the index holds (0-dim
    int64 on the device)."""
    ids = packed.part_ids
    elig = (ids >= 0) & (bits[ids.clamp(min=0).to(torch.int64)] > 0)
    part, slot = torch.nonzero(elig, as_tuple=True)
    pos = (torch.cumsum(elig, 1) - 1)[part, slot]
    counts = elig.sum(1).to(torch.int32)
    width = max(int(counts.max()), 1) if counts.numel() else 1
    eid = ids[part, slot]
    out_ids = ids.new_full((ids.shape[0], width), -1)
    out_ids[part, pos] = eid
    codes = packed.part_codes
    if codes is not None:
        out_codes = codes.new_zeros((codes.shape[0], width, codes.shape[2]))
        out_codes[part, pos] = codes[part, slot]
        codes = out_codes
    held = torch.zeros(bits.shape[0], dtype=torch.bool, device=ids.device)
    held[eid.to(torch.int64)] = True
    return (PackedIVF(packed.centroids, out_ids, codes, counts, counts, packed.pq,
                      packed.rerank, packed.router), held.sum())


def _subset(packed: PackedIVF, bits: torch.Tensor, final_k: int,
            rerank_budget: int) -> _Subset:
    sub, population = filtered_pack(packed, bits)
    stage = rerank_budget if packed.part_codes is not None else final_k
    return _Subset(sub, packed.extent, population.clamp(max=stage))


def _budget_pass(sub: _Subset, Q: torch.Tensor, router, top_t: int, final_k: int,
                 rerank_budget: int, multiplicity: int, rows: int, route=None):
    """One pass over the eligible slots → (ids, scores, surviving), -1 /
    -inf at the ranks past the unique candidates found. Counts
    into the span innermost on this thread, over the first `rows` rows of
    Q (the rest pad the tile): `probed` partitions, `gathered` slots of
    the whole index under them and `scored`, the eligible ones among
    them, which alone reach the scorer and the dedup. route: the router's
    (scores, parts) when already taken, at top_t or wider (cut here)."""
    if route is None:
        with span("search.route"):
            route = router.route(Q, top_t)
    psc, parts = route[0][:, :top_t], route[1][:, :top_t]
    if recording():
        live = torch.isfinite(psc)
        live[rows:] = False
        count(probed=live, gathered=torch.where(live, sub.extent[parts], 0),
              scored=torch.where(live, sub.packed.extent[parts], 0))
    ids, vals, surv = _search_pass(sub.packed, Q, router, top_t, final_k, rerank_budget,
                                   multiplicity, route=(psc, parts), survivors=True,
                                   rows=rows)
    # a rank past the candidates found holds -1 (not a copy of a found id)
    return torch.where(torch.isfinite(vals), ids, -1), vals, surv


def _padded(Q: torch.Tensor, tile_rows: Optional[int]) -> torch.Tensor:
    """Q with zero rows appended up to tile_rows (None: as it is)."""
    n = Q.shape[0]
    if tile_rows is None or n >= tile_rows:
        return Q
    return torch.cat([Q, Q.new_zeros((tile_rows - n, Q.shape[1]))])


def settle_steps(sub: _Subset, parts: torch.Tensor, widths, multiplicity: int):
    """Each row's escalation step from one count → (steps (n,) int64,
    settled (n,) bool), for a router whose steps are prefixes of one
    route. parts: (n, ≥ widths[-1]) each row's partitions in route order;
    widths: the probe width of steps 1, 2, … (`nested_steps`).

    A row's step is the first whose probes hold `sub.thresh` unique
    eligible ids: the walk's rule, as a pass's surviving count is
    min(unique eligible ids, stage budget) wherever an id holds at most
    `multiplicity` window slots, as the dedup assumes. So the count needs
    no prefix past the first step whose eligible slots reach multiplicity
    · thresh; one sync reads that width. Under it: the eligible ids of
    the prefix in probe order, each id's first occurrence marked (a
    stable sort by id), cumulated per probe and read at each step's
    width. A row whose count reaches thresh at no step within the prefix
    (an id held more often than assumed) is not `settled` and takes the
    last step."""
    n = parts.shape[0]
    slots = sub.packed.extent[parts[:, :widths[-1]]].cumsum(1)        # (n, c')
    short = torch.stack([slots[:, w - 1] for w in widths], 1) < multiplicity * sub.thresh
    wide = widths[min(int(short.sum(1).amax()), len(widths) - 1)]     # the one sync
    ids = sub.packed.part_ids[parts[:, :wide]]                         # (n, wide, W)
    srt, pos = torch.sort(ids.reshape(n, -1), dim=1, stable=True)
    first = torch.ones_like(srt, dtype=torch.bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    new = torch.zeros_like(first).scatter_(1, pos, first & (srt >= 0))
    uniq = new.reshape(ids.shape).sum(2).cumsum(1)                     # (n, wide)
    reached = torch.stack([uniq[:, w - 1] for w in widths if w <= wide], 1) >= sub.thresh
    settled = reached.any(1)
    steps = torch.where(settled, (~reached).sum(1) + 1, len(widths))
    return steps, settled


def _search_block_budget(sub: _Subset, Q: torch.Tensor, rows: int, router, t: int,
                         final_k: int, rerank_budget: int, multiplicity: int = 2,
                         tile_rows: Optional[int] = None):
    """`escalate="budget"` over one tile whose first `rows` rows are queries
    (the rest pad it and never escalate). A row is thin while its unique
    eligible candidates are fewer than `sub.thresh`; it takes router-
    escalation steps (flat: doubled top_t; tree: doubled top_t and
    t_route) until it is not thin or the router cannot escalate, and its
    answer is that of the pass at the step where it stopped. Every pass
    after the first runs at `tile_rows` rows when given, so a query's
    bits do not depend on its tile mates.

    Where the router's steps are prefixes of one route (`nested_steps`:
    flat), the first pass takes the route at the widest step, cut, and
    `settle_steps` finds each thin row's step from it at once; then one
    pass a step present runs over the rows settled there. The span
    "search.escalate", one a tile, counts `rows` entering, `step` and
    `top_t` of the widest settled, `kept` (every row entering), `settled`
    (rows whose step the count decided) and `passes`. Else each step is a
    pass over the rows still thin, its own span "search.escalate" (counts
    `step`, `top_t`, `rows` entering, `kept`: rows that stop there).
    router and t: the call's, resolved and clamped once
    (`search_jit_batched`)."""
    widths = router.nested_steps(t)
    route = None
    if widths:
        with span("search.route"):
            route = router.route(Q, widths[-1])
    ids, vals, surv = _budget_pass(sub, Q, router, t, final_k, rerank_budget,
                                   multiplicity, rows, route)
    thin = torch.nonzero(surv[:rows] < sub.thresh)[:, 0]
    if widths is not None:
        if thin.numel() and widths:
            _settle(sub, Q, route[1], thin, ids, vals, widths, final_k,
                    rerank_budget, multiplicity, router, tile_rows)
        return ids, vals
    step = 0
    while thin.numel() and router.can_escalate(t):
        step += 1
        router, t = router.escalated(t)
        n = thin.numel()
        with span("search.escalate", step=step, top_t=t, rows=n) as esc:
            i2, v2, s2 = _budget_pass(sub, _padded(Q[thin], tile_rows), router, t,
                                      final_k, rerank_budget, multiplicity, n)
            ids[thin], vals[thin] = i2[:n], v2[:n]
            still = s2[:n] < sub.thresh
            esc.count(kept=~still if router.can_escalate(t) else n)
            thin = thin[still]
    return ids, vals


def _settle(sub: _Subset, Q: torch.Tensor, parts: torch.Tensor, thin: torch.Tensor,
            ids: torch.Tensor, vals: torch.Tensor, widths, final_k: int,
            rerank_budget: int, multiplicity: int, router, tile_rows: Optional[int]):
    """The thin rows' steps settled (`settle_steps` over their rows of the
    tile's route, parts), then one pass a step present over the rows
    settled there, written into ids / vals."""
    n = thin.numel()
    with span("search.escalate", rows=n) as esc:
        steps, settled = settle_steps(sub, parts[thin], widths, multiplicity)
        order = torch.argsort(steps, stable=True)
        per_step = torch.zeros(len(widths) + 1, dtype=steps.dtype, device=steps.device)
        per_step = per_step.scatter_add_(0, steps, torch.ones_like(steps)).tolist()
        rows, at = thin[order], 0
        for s, m in enumerate(per_step):
            if not m:
                continue
            r = rows[at:at + m]
            at += m
            i2, v2, _ = _budget_pass(sub, _padded(Q[r], tile_rows), router, widths[s - 1],
                                     final_k, rerank_budget, multiplicity, m)
            ids[r], vals[r] = i2[:m], v2[:m]
        top = max(s for s, m in enumerate(per_step) if m)
        esc.count(step=top, top_t=widths[top - 1], kept=n, settled=settled,
                  passes=sum(1 for m in per_step if m))


def _filter_bits(packed: PackedIVF, filter) -> Optional[torch.Tensor]:
    """The (n,) filter as a uint8 tensor on the index's device (None stays
    None). A length other than the index's point count raises."""
    if filter is None:
        return None
    bits = as_tensor(filter, packed.centroids.device)
    n = rerank_table(packed.rerank).shape[0]
    if bits.dim() != 1 or bits.shape[0] != n:
        raise ValueError(f"filter must be an ({n},) bitmap over the index's "
                         f"points, got shape {tuple(bits.shape)}")
    return bits.to(torch.uint8)


def search_jit(packed: PackedIVF, Q, top_t: int, final_k: int,
               rerank_budget: int = 256, multiplicity: int = 2, filter=None,
               escalate: Union[bool, str] = True, router=None):
    """Batched search of all of Q at once → (ids (nq, final_k) int32,
    scores (nq, final_k)). Q: (nq, d) numpy array or tensor.

    filter: optional (n,) bitmap over point ids (0 = drop), gathered per
    candidate window; with `escalate` True a second router-escalated pass
    backs thin filtered windows, and with "budget" thin rows walk up the
    escalation steps to the stage budget over the eligible slots alone
    (`_search_block_budget`). router: the probe router; default the one
    packed on the index, else the flat probe. It is `search_jit_batched`
    over one tile of every row, run at its own size.
    """
    return search_jit_batched(packed, Q, top_t, final_k, rerank_budget,
                              bq=max(len(Q), 1), multiplicity=multiplicity,
                              filter=filter, escalate=escalate, router=router)


def bq_bucket(nq: int, bq: int) -> int:
    """Power-of-two query-count bucket (≥ 8), capped at the tile size."""
    return min(bq, max(8, 1 << (max(nq, 1) - 1).bit_length()))


def pad_queries(Q: np.ndarray, bq_cap: int, multiple: int = 1):
    """Host-side bucket padding: (nq, d) → (padded Q, nq, bucket)."""
    Q = np.atleast_2d(np.asarray(Q, np.float32))
    nq = Q.shape[0]
    bq = bq_bucket(nq, bq_cap)
    step = bq * multiple // np.gcd(bq, multiple) if multiple > 1 else bq
    pad = (-nq) % step
    Qp = np.pad(Q, ((0, pad), (0, 0))) if pad else Q
    return Qp, nq, bq


def search_jit_batched(packed: PackedIVF, Q, top_t: int, final_k: int,
                       rerank_budget: int = 256, bq: int = 128,
                       multiplicity: int = 2, filter=None,
                       escalate: Union[bool, str] = True, router=None,
                       tile_rows: Optional[int] = None,
                       queries: Optional[int] = None):
    """`search_jit` over bq-query tiles, so live buffers stay
    O(bq·top_t·pmax) whatever nq. Every stage is query-local, so a tile's
    results do not depend on the others. `filter`/`escalate`/`router` as
    in search_jit, shared by every tile.

    tile_rows: run every tile at this many rows (zero queries appended,
    their results dropped). On the card cuBLAS picks a product's algorithm
    by its shape, so the rerank and flat-route products of a query give
    other bits in a tile of 16 rows than in one of 8; at one fixed row
    count a query's results are the same bits whatever shares its tile
    (the serving engine's coalesced ≡ solo guarantee). None runs each
    tile at its own size.

    queries: the rows of Q that are queries (default all); the rest pad
    the batch, and under `escalate="budget"` never escalate."""
    Q = as_tensor(Q, packed.centroids.device, torch.float32)
    filter = _filter_bits(packed, filter)
    check_query_dim(Q, packed.centroids.shape[1])
    nq = Q.shape[0]
    if nq == 0:
        dev = Q.device
        return (torch.zeros((0, final_k), dtype=torch.int32, device=dev),
                torch.zeros((0, final_k), dtype=torch.float32, device=dev))
    if router is None:
        router = packed.router if packed.router is not None \
            else FlatRouter(packed.centroids)
    top_t = router.clamp(top_t)
    sub = None
    if filter is not None and escalate == ESCALATE_BUDGET:
        sub = _subset(packed, filter, final_k, rerank_budget)
    real = nq if queries is None else min(int(queries), nq)
    outs = []
    for i0 in range(0, nq, bq):
        with span("search.tile", tile=i0 // bq):
            Qt = Q[i0:i0 + bq]
            n = Qt.shape[0]
            Qt = _padded(Qt, tile_rows)
            if sub is not None:
                ids, vals = _search_block_budget(
                    sub, Qt, max(0, min(n, real - i0)), router, top_t, final_k,
                    rerank_budget, multiplicity, tile_rows)
            else:
                ids, vals = _search_block(packed, Qt, router, top_t, final_k, rerank_budget,
                                          multiplicity, filter, escalate,
                                          max(0, min(n, real - i0)))
            outs.append((ids[:n], vals[:n]))
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))


# --------------------------------------------------------------------------
# The host engine: ragged search over the CSR index
# --------------------------------------------------------------------------

CAND_CHUNK = 1 << 20    # candidates (query, assignment) gathered per step


class SearchStats(NamedTuple):
    points_read: torch.Tensor         # (nq,) int64 assignments scanned (incl. duplicates)
    unique_candidates: torch.Tensor   # (nq,) int64


def _ragged_gather(starts: torch.Tensor, top_parts: torch.Tensor,
                   part_scores: torch.Tensor):
    """Batch-level CSR gather: one flat index vector for every (query,
    partition) segment of the batch.

    Returns (cand_rows, qidx, seg_score, row_lens): the flat CSR row of
    each candidate, its query, its partition's router score (the coarse
    ⟨q, centroid⟩ term the PQ stage adds back) and per-query totals.
    """
    nq, t = top_parts.shape
    p = top_parts.to(torch.int64)
    seg_starts = starts[p].reshape(-1)                           # (nq*t,)
    seg_lens = (starts[p + 1] - starts[p]).reshape(-1)
    offs = torch.cumsum(seg_lens, 0)
    total = int(offs[-1]) if offs.numel() else 0
    dev = starts.device
    cand_rows = (torch.arange(total, device=dev)
                 + torch.repeat_interleave(seg_starts - (offs - seg_lens), seg_lens,
                                           output_size=total))
    row_lens = seg_lens.reshape(nq, t).sum(1)
    qidx = torch.repeat_interleave(torch.arange(nq, device=dev), row_lens,
                                   output_size=total)
    seg_score = torch.repeat_interleave(part_scores.to(torch.float32).reshape(-1),
                                        seg_lens, output_size=total)
    return cand_rows, qidx, seg_score, row_lens


def _group_ranks(group: torch.Tensor, n_groups: int) -> torch.Tensor:
    """Rank of each element within its (sorted, contiguous) group."""
    starts = torch.searchsorted(group, torch.arange(n_groups, device=group.device))
    return torch.arange(group.shape[0], device=group.device) - starts[group]


def _run_starts(order: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """The entries of `order` that start a run of equal key[order]."""
    key_s = key[order]
    first = torch.ones_like(key_s, dtype=torch.bool)
    first[1:] = key_s[1:] != key_s[:-1]
    return order[first]


def _lexsort_desc(val: torch.Tensor, group: torch.Tensor) -> torch.Tensor:
    """`np.lexsort((-val, group))`: by group ascending, then val descending,
    then position — a stable descending sort on val, then a stable sort on
    group."""
    o1 = torch.sort(val, descending=True, stable=True).indices
    return o1[torch.sort(group[o1], stable=True).indices]


def search_numpy(index: IVFIndex, Q, top_t: int, final_k: int = 10,
                 rerank_budget: int = 0, filter_mask=None, escalate: bool = True,
                 router=None):
    """The host engine (ScaNN's CPU engine shape), in torch on the index's
    device → (ids (nq, final_k) int32, SearchStats of (nq,) int64 tensors).

    The name is the JAX package's: there the engine runs in numpy on the
    host. Per pass: the router's probe, one ragged CSR gather of every
    (query, partition) segment, PQ LUT scores + the coarse term, per-query
    dedup by (query, id) keeping the best approximate score, the top
    rerank_budget per query, exact rerank, top final_k. rerank_budget=0
    (or an index without codes) scores every candidate exactly. Queries
    are walked in chunks of about CAND_CHUNK candidates; every stage is
    query-local, so chunking changes no result.

    filter_mask: optional (n_points,) bitmap over point ids; filtered
    candidates drop at the gather. A short mask zero-pads (ids past it are
    excluded) and a long one is cut at n_points, unlike `search_jit`'s
    strict length. With `escalate`, queries whose unique surviving
    candidates are fewer than the stage budget (rerank_budget with a PQ
    stage, else final_k, capped at the filter's population) re-probe one
    router escalation step up, host-driven, until satisfied or the router
    is exhausted.

    router: the probe router; default the index's own, else the flat probe.
    Its `route` runs here (ties to the lowest index), where the JAX host
    engine calls `route_numpy`.
    """
    dev = index.centroids.device
    Q = as_tensor(Q, dev, torch.float32)
    if router is None:
        router = index.router or FlatRouter(index.centroids)
    check_query_dim(Q, index.centroids.shape[1])
    if Q.shape[0] == 0:
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        return (torch.full((0, final_k), -1, dtype=torch.int32, device=dev),
                SearchStats(z, z))
    top_t = router.clamp(top_t)
    fm = None
    if filter_mask is not None:
        n = index.n_points
        mm = as_tensor(filter_mask, dev).reshape(-1)[:n].to(torch.bool)
        fm = torch.zeros(n, dtype=torch.bool, device=dev)
        fm[:mm.shape[0]] = mm
    data = index.rerank_f32 if index.rerank_f32 is not None else index.rerank_int8
    out, row_lens, uniq = _search_numpy_pass(index, Q, data, router, top_t,
                                             final_k, rerank_budget, fm)
    if fm is not None and escalate:
        use_pq = index.codes is not None and rerank_budget > 0
        thresh = min(rerank_budget if use_pq else final_k, int(fm.sum()))
        r, t = router, top_t
        thin = torch.nonzero(uniq < thresh).reshape(-1)
        while thin.numel() and r.can_escalate(t):
            r, t = r.escalated(t)
            o2, r2, u2 = _search_numpy_pass(index, Q[thin], data, r, t,
                                            final_k, rerank_budget, fm)
            out[thin], row_lens[thin], uniq[thin] = o2, r2, u2
            thin = thin[u2 < thresh]
    return out, SearchStats(row_lens, uniq)


def _search_numpy_pass(index: IVFIndex, Q: torch.Tensor, data,
                       router, top_t: int, final_k: int, rerank_budget: int,
                       fm: Optional[torch.Tensor]):
    """One fixed-top_t pass of the host engine → (out, points_read,
    unique_candidates), so the escalation loop can splice rows. The
    route runs on the whole batch; the rest walks chunks of queries of
    about CAND_CHUNK candidates (at least one query a chunk)."""
    nq = Q.shape[0]
    psc, top_parts = router.route(Q, top_t)
    starts = index.starts
    p = top_parts.to(torch.int64)
    row_lens = (starts[p + 1] - starts[p]).sum(1)
    cum = torch.cumsum(row_lens, 0).cpu().numpy()
    out = torch.full((nq, final_k), -1, dtype=torch.int32, device=Q.device)
    uniq = torch.zeros(nq, dtype=torch.int64, device=Q.device)
    q0 = 0
    while q0 < nq:
        base = int(cum[q0 - 1]) if q0 else 0
        q1 = max(q0 + 1, int(np.searchsorted(cum, base + CAND_CHUNK, side="right")))
        out[q0:q1], uniq[q0:q1] = _search_numpy_chunk(
            index, Q[q0:q1], data, psc[q0:q1], top_parts[q0:q1], final_k,
            rerank_budget, fm)
        q0 = q1
    return out, row_lens, uniq


def _search_numpy_chunk(index: IVFIndex, Q: torch.Tensor, data,
                        psc: torch.Tensor, top_parts: torch.Tensor, final_k: int,
                        rerank_budget: int, fm: Optional[torch.Tensor]):
    """The gather, scoring, dedup and rerank of one chunk of queries →
    (out (nq, final_k) int32, unique_candidates (nq,) int64)."""
    nq = Q.shape[0]
    use_pq = index.codes is not None and rerank_budget > 0
    cand_rows, qidx, seg_score, _ = _ragged_gather(index.starts, top_parts, psc)
    cand_ids = index.point_ids[cand_rows].to(torch.int64)
    if fm is not None:
        # subset masking at the gather: filtered candidates never reach
        # scoring, dedup or the rerank budget
        keep = fm[cand_ids]
        cand_rows, qidx = cand_rows[keep], qidx[keep]
        seg_score, cand_ids = seg_score[keep], cand_ids[keep]
    # composite (query, id) key: one dedup pass for the whole chunk
    key = qidx * index.n_points + cand_ids
    if use_pq:
        luts = pq_lut(index.pq, Q).reshape(-1)                 # (nq·m·16,)
        codes = index.codes[cand_rows]                         # (total, m)
        m = codes.shape[1]
        lut_row = qidx * (m * 16)
        approx = luts[lut_row + codes[:, 0].to(torch.int64)]
        for j in range(1, m):   # one gather a subspace, summed in subspace order
            approx += luts[lut_row + (j * 16) + codes[:, j].to(torch.int64)]
        approx += seg_score                                    # + ⟨q, centroid⟩
        # dedup: the best approx score per (query, id)
        sel = _run_starts(_lexsort_desc(approx, key), key)
        # per-query budget by approx, descending
        sel = sel[_lexsort_desc(approx[sel], qidx[sel])]
        sel = sel[_group_ranks(qidx[sel], nq) < rerank_budget]
    else:
        # the first candidate of each (query, id), as np.unique's index
        sel = _run_starts(torch.sort(key, stable=True).indices, key)
    qs, ids_sel = qidx[sel], cand_ids[sel]
    uniq = torch.bincount(qs, minlength=nq)
    if isinstance(data, Int8Data):
        exact = int8_scores_ref(Q[qs], data.q, data.scale, ids_sel[:, None])[:, 0]
    else:
        exact = (data[ids_sel] * Q[qs]).sum(1)
    order = _lexsort_desc(exact, qs)
    qs, ids_sel = qs[order], ids_sel[order]
    rank = _group_ranks(qs, nq)
    top = rank < final_k
    out = torch.full((nq, final_k), -1, dtype=torch.int32, device=Q.device)
    out[qs[top], rank[top]] = ids_sel[top].to(torch.int32)
    return out, uniq
