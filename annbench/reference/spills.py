"""Plain reference of an index whose rows are held in a primary partition
and more than one SOAR spill (Sun et al. 2023, §3.5.1).

Column 0 is a row's nearest partition; spill j (column j ≥ 1) minimizes
‖x − c‖² + λ Σ_{i<j} (⟨r̂_i, x⟩ − ⟨r̂_i, c⟩)² over the partitions no
earlier column took, r̂_i the unit residual to column i, the penalty
summed over the earlier columns in column order. The served index holds
a row's partitions as a set (its slots), so `gaps` reads every order of
the set and keeps, a row, the one whose widest gap is least, as
`build.pair_gaps` does for one spill; `index` gives the numbers
`compare.index` gives for one spill (assign_gap, spill_gap over every
spill, code_gap, slot_bad) at any number of columns. `choices` are the
reference's own columns, which the control puts in the program's place.
"""
from __future__ import annotations

import itertools
from typing import Dict

import torch

from annbench.reference import build as rb
from annbench.reference.precision import operand, rowdot

BLOCK = 16_384


def _penalty(xb, C, part, prec):
    """(⟨r̂, x⟩ − ⟨r̂, c_j⟩)² for every partition j, r̂ the unit residual to
    `part` (b,) → (b, c)."""
    r = xb - C[part]
    rhat = r / torch.linalg.vector_norm(r, dim=1, keepdim=True).clamp(min=1e-30)
    proj = torch.addmm(rowdot(rhat, xb, prec)[:, None], operand(rhat, prec),
                       operand(C, prec).T, alpha=-1.0)
    return proj.square_()


def choices(X, C, lam: float, n_spills: int, prec: str = "f32") -> torch.Tensor:
    """The reference's columns of every row → (n, 1 + n_spills) int64."""
    out = []
    for i in range(0, X.shape[0], BLOCK):
        xb = X[i:i + BLOCK]
        d = rb._sqdist(xb, C, prec)
        cols = [d.argmin(1)]
        pen = torch.zeros_like(d)
        for _ in range(n_spills):
            pen += _penalty(xb, C, cols[-1], prec)
            loss = d + lam * pen
            loss.scatter_(1, torch.stack(cols, 1), float("inf"))
            cols.append(loss.argmin(1))
        out.append(torch.stack(cols, 1))
    return torch.cat(out)


def gaps(X, C, sets: torch.Tensor, lam: float):
    """(assign_gap, spill_gap) of each row's partitions sets (n, a), in
    any order; rows holding a -1 are skipped. For each order: column 0's
    ‖x − c‖² above the least over all partitions, and each later column's
    loss above the least over partitions no earlier column took; a row
    reads the order whose widest gap is least; each number is the widest
    over rows (spill_gap over every spill)."""
    ag = sg = 0.0
    sets = sets.long()
    a = sets.shape[1]
    orders = list(itertools.permutations(range(a)))
    for i in range(0, X.shape[0], BLOCK):
        S = sets[i:i + BLOCK]
        ok = (S >= 0).all(1)
        if not bool(ok.any()):
            continue
        xb, S = X[i:i + BLOCK][ok], S[ok]
        d = rb._sqdist(xb, C, "f32")
        pen = [_penalty(xb, C, S[:, j], "f32") for j in range(a)]
        step: Dict[frozenset, tuple] = {}       # earlier columns → (loss at the set, least)

        def loss_of(earlier):
            key = frozenset(earlier)
            if key not in step:
                loss = d.clone()
                for j in sorted(key):
                    loss += lam * pen[j]
                if key:
                    loss.scatter_(1, S[:, sorted(key)], float("inf"))
                step[key] = (loss.gather(1, S), loss.min(1).values)
            return step[key]

        per = []                                 # (b, a) gaps of each order
        for o in orders:
            g = torch.stack([loss_of(o[:j])[0][:, o[j]] - loss_of(o[:j])[1]
                             for j in range(a)], 1)
            per.append(g)
        per = torch.stack(per)                   # (orders, b, a)
        pick = per.amax(2).argmin(0)             # (b,)
        best = per[pick, torch.arange(per.shape[1], device=per.device)]
        ag = max(ag, float(best[:, 0].max()))
        if a > 1:
            sg = max(sg, float(best[:, 1:].max()))
    return ag, sg


def index(X, C, centers, point, part, codes, lam: float, per_row: int) -> Dict[str, float]:
    """The numbers of an index's assignments, every (row, partition) pair
    it holds with the pair's PQ code (n_assign, m): assign_gap, spill_gap,
    code_gap and slot_bad (slots naming no row or partition, a pair held
    twice, rows not held exactly per_row times)."""
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
    sets = torch.full((n, per_row), -1, dtype=torch.int64, device=X.device)
    keep = pos < per_row
    sets[row[keep], pos[keep]] = prt[keep]
    sets[cnt != per_row] = -1
    ag, sg = gaps(X, C, sets, lam)
    return {"assign_gap": ag, "spill_gap": sg,
            "code_gap": rb.code_gap(X, C, centers, point, part, codes), "slot_bad": bad}


def index_control(X, C, centers, lam: float, n_spills: int) -> Dict[str, float]:
    """The same numbers of the reference's own TF32 columns and codes over
    the same codebooks, in the program's place."""
    cols = choices(X, C, lam, n_spills, "tf32")
    point = torch.arange(X.shape[0], device=X.device).repeat_interleave(cols.shape[1])
    part = cols.reshape(-1)
    codes = rb.code_choice(X, C, centers, point, part, "tf32")
    return index(X, C, centers, point, part, codes, lam, cols.shape[1])
