"""The comparison that decides `correct`.

Every number compared has a limit of its own, in `limits/<workload>.json`,
set from readings of the program and of its control on the chip (PERF.md
gives both). A number passes when it is finite and at or below its limit;
an exact count has the limit 0.

Search answers are judged against exact float32 inner products of the
benchmark's own vectors and against the reference search over the same
index (`reference/search.py`):

- score_err: the widest gap between a returned score and the exact inner
  product of the returned id (the rerank, and that each id is its query's);
- rank_gap: the widest amount by which the exact score at some rank of an
  answer lies below the reference's at that rank (route, PQ scoring, dedup
  and the rerank budget: a candidate lost on the way shows here);
- miss_share: the share of the reference's ids an answer lacks;
- bad_ids: ranks with no valid id where the reference has one;
- dup_ids: an id returned twice for one query.

The index a search follows is judged apart, against the benchmark's own
vectors and the index's codebooks (`index`, `reference/build.py`):

- assign_gap: the widest ||x − c||² of a row's nearer partition above the
  least over all partitions;
- spill_gap: the widest SOAR loss of its other partition above the least
  over partitions other than the nearer (inf where both are one);
- code_gap: the widest residual-to-centre distance of a PQ code above the
  nearest centre's;
- slot_bad: slots naming no row or partition, a (row, partition) pair held
  twice, and rows not held exactly 1 + n_spills times;
- router_bad, router_gap: the tree router's tables (`reference/router.py`);
- codebook_excess, pq_excess (the build cell): the k-means distortion of
  the codebook over every row, and the PQ distortion of every assignment's
  residual, each over that of the reference's own training, less 1.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, NamedTuple

import torch

from annbench.reference import build as rb
from annbench.reference.search import exact_scores


class Check(NamedTuple):
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def limits(bench_dir: Path, workload: str) -> Dict[str, float]:
    return json.loads((bench_dir / "limits" / f"{workload}.json").read_text())


def checks(numbers: Dict[str, float], lim: Dict[str, float]):
    """One Check a limited number; a number with no limit is refused."""
    missing = sorted(set(numbers) - set(lim))
    if missing:
        raise KeyError(f"no limit for {missing}")
    return [Check(k, float(numbers[k]), float(lim[k])) for k in sorted(numbers)]


def answers(rows: torch.Tensor, Q: torch.Tensor, ids: torch.Tensor,
            scores: torch.Tensor, ref_ids: torch.Tensor) -> Dict[str, float]:
    """Numbers of one set of answers: ids, scores (nq, k) of the program,
    ref_ids (nq, k) of the reference search (-1 where it has fewer)."""
    ids = ids.long().to(Q.device)
    scores = scores.to(Q.device, torch.float32)
    ref_ids = ref_ids.long().to(Q.device)
    n = rows.shape[0]
    valid = (ids >= 0) & (ids < n)
    ex = exact_scores(rows, Q, ids)
    err = torch.where(valid, (scores - ex).abs(), 0.0)
    score_err = float(err.max()) if err.numel() else 0.0
    if not bool(torch.isfinite(torch.where(valid, scores, 0.0)).all()):
        score_err = math.inf
    ref_ex = exact_scores(rows, Q, ref_ids)
    mine = torch.sort(ex, 1, descending=True).values
    ref = torch.sort(ref_ex, 1, descending=True).values
    has = torch.isfinite(ref)
    gap = torch.where(has, ref - mine, 0.0)
    gap = torch.where(torch.isnan(gap), math.inf, gap)
    rank_gap = max(0.0, float(gap.max())) if gap.numel() else 0.0
    ref_valid = ref_ids >= 0
    found = (ref_ids[:, :, None] == torch.where(valid, ids, -2)[:, None, :]).any(2)
    miss = float((ref_valid & ~found).sum()) / max(1, int(ref_valid.sum()))
    srt = torch.sort(torch.where(valid, ids, -1), 1).values
    dup = int(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).sum())
    bad = int((ref_valid.sum(1) - valid.sum(1)).clamp(min=0).sum())
    return {"score_err": score_err, "rank_gap": rank_gap, "miss_share": miss,
            "bad_ids": bad, "dup_ids": dup}


def worst(*sets: Dict[str, float]) -> Dict[str, float]:
    """The largest reading of each number over several sets of answers."""
    out: Dict[str, float] = {}
    for s in sets:
        for k, v in s.items():
            out[k] = max(out.get(k, -math.inf), v)
    return out


def slots(part_ids: torch.Tensor):
    """(row, partition, flat slot) of every filled slot of a (c, cap) table."""
    cap = part_ids.shape[1]
    flat = part_ids.reshape(-1).long()
    slot = torch.nonzero(flat >= 0)[:, 0]
    return flat[slot], slot // cap, slot


def index(X, C, centers, point, part, codes, lam: float, per_row: int) -> Dict[str, float]:
    """The numbers of an index's assignments: every (row, partition) pair it
    holds, with the pair's PQ code (n_assign, m)."""
    if per_row != 2:
        raise ValueError("the index numbers judge one spill a row")
    n, c = X.shape[0], C.shape[0]
    point, part = point.long(), part.long()
    ok = (point >= 0) & (point < n) & (part >= 0) & (part < c)
    bad = int((~ok).sum())
    point, part, codes = point[ok], part[ok], codes[ok]
    key = torch.unique(point * c + part)
    bad += point.numel() - key.numel()
    row, prt = key // c, key % c
    cnt = torch.bincount(row, minlength=n)
    bad += int((cnt != per_row).sum())
    pos = torch.arange(key.numel(), device=key.device) - (torch.cumsum(cnt, 0) - cnt)[row]
    pairs = torch.full((n, 2), -1, dtype=torch.int64, device=X.device)
    keep = pos < 2
    pairs[row[keep], pos[keep]] = prt[keep]
    ag, sg = rb.pair_gaps(X, C, pairs, lam)
    return {"assign_gap": ag, "spill_gap": sg,
            "code_gap": rb.code_gap(X, C, centers, point, part, codes), "slot_bad": bad}


def index_control(X, C, centers, lam: float) -> Dict[str, float]:
    """The same numbers of the reference's own TF32 assignments and codes
    over the same codebooks, in the program's place."""
    prim = rb.assign_choice(X, C, "tf32")
    spill = rb.spill_choice(X, C, prim, lam, "tf32")
    point = torch.arange(X.shape[0], device=X.device).repeat_interleave(2)
    part = torch.stack([prim, spill], 1).reshape(-1)
    codes = rb.code_choice(X, C, centers, point, part, "tf32")
    return index(X, C, centers, point, part, codes, lam, 2)
