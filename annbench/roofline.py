"""The yardstick: the card's published peaks and the least work of each
operation the benchmark prices, counted from the inputs and the index's
state, never from what the program computed on the way.

Counting rule (the same for every operation): each input byte read once,
each output byte written once; f32 products priced as 3×TF32 on the tensor
cores, other f32 work at the SIMT rate. The least time is the larger of the
bytes' time and the operations' time. The rule of the search pass is that of
`chip_smoke.py::needed_step_bytes` (each distinct probed partition and each
distinct rerank row read once), with the routing, LUT and rerank products
added.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# NVIDIA H100 SXM (data sheet; dense rates, at the full 700 W power limit)
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_TF32_S = 495e12


class Work(NamedTuple):
    nbytes: float
    ops: float = 0.0        # f32 work outside products (SIMT rate)
    mm_ops: float = 0.0     # f32 product operations (3×TF32)

    def __add__(self, o: "Work") -> "Work":
        return Work(self.nbytes + o.nbytes, self.ops + o.ops, self.mm_ops + o.mm_ops)

    def scaled(self, k: float) -> "Work":
        return Work(self.nbytes * k, self.ops * k, self.mm_ops * k)

    def seconds(self) -> float:
        """The least time: bytes at the memory rate, or operations at
        their peaks, whichever is longer."""
        t_bytes = self.nbytes / PEAK_BYTES_S
        t_ops = self.ops / PEAK_F32_S + 3.0 * self.mm_ops / PEAK_TF32_S
        return max(t_bytes, t_ops)


def share_pct(work: Work, seconds: float):
    """The least time over the measured time, in percent; None where
    nothing was measured."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * work.seconds() / seconds


def extents(part_ids: torch.Tensor) -> torch.Tensor:
    """(c,) int64: each partition's last slot holding an id, plus one."""
    slot = torch.arange(1, part_ids.shape[1] + 1, device=part_ids.device)
    return torch.where(part_ids >= 0, slot, 0).amax(1)


def probe_scoring(ext: torch.Tensor, parts: torch.Tensor, m: int) -> Work:
    """PQ LUT scoring of each query's probed partitions (nq, t): the LUTs,
    probe ids and coarse scores read once, each distinct probed partition's
    extent and code rows up to it read once, one f32 score written a
    (query, probed slot), one LUT add a code byte of each query's window."""
    nq, t = parts.shape
    p = parts.reshape(-1).long()
    distinct = torch.unique(p)
    window = int(ext[p].sum())
    return Work(nq * m * 16 * 4 + nq * t * 8 + distinct.numel() * 4
                + int(ext[distinct].sum()) * m + window * 4,
                ops=float(window) * m)


def flat_route(nq: int, c: int, d: int, t: int) -> Work:
    """Q·Cᵀ and its top-t: queries and centroids read, (nq, t) scores and
    ids written, 2·nq·c·d product operations."""
    return Work((nq + c) * d * 4 + nq * t * 8, mm_ops=2.0 * nq * c * d)


def tree_route(supers_probed: torch.Tensor, children: torch.Tensor, nq: int,
               S: int, d: int) -> Work:
    """Two-level route: queries and super centroids read; each distinct
    probed super's child rows and ids read once; a score and an id written
    for every child of each query's probed supers; products with every
    super and with those children."""
    live = (children >= 0).sum(1)                      # (S,) children per super
    sp = supers_probed.reshape(-1).long()
    distinct = torch.unique(sp)
    n_dist = int(live[distinct].sum())
    per_query = int(live[sp].sum())                    # Σ over queries of their children
    return Work((nq + S) * d * 4 + n_dist * (d * 4 + 4) + per_query * 8,
                mm_ops=2.0 * d * (nq * S + per_query))


def search_pass(*, nq: int, d: int, c: int, m: int, k: int, budget: int,
                route: Work, ext: torch.Tensor, parts: torch.Tensor,
                n_rerank_rows: int) -> Work:
    """A whole search of nq queries: the route; the queries, centroids and
    PQ codebook read once; each distinct probed partition's extent, codes
    and ids up to it read once; the LUTs' products and one add a code byte
    of each query's window; each distinct rerank row read once and nq·budget
    rerank products; (nq, k) ids and scores written."""
    p = parts.reshape(-1).long()
    distinct = torch.unique(p)
    window = int(ext[p].sum())
    s = d // m
    return route + Work(
        (nq + c) * d * 4 + m * 16 * s * 4 + distinct.numel() * 4
        + int(ext[distinct].sum()) * (m + 4) + n_rerank_rows * d * 4 + nq * k * 8,
        ops=float(window) * m,
        mm_ops=2.0 * nq * (m * 16 * s + budget * d))


def lloyd_sweep(n: int, c: int, d: int) -> Work:
    """One Lloyd sweep: rows and centroids read, new centroids and counts
    written; 2·n·c·d assignment products; one add a row element."""
    return Work((n + 2 * c) * d * 4 + c * 4, ops=float(n) * d, mm_ops=2.0 * n * c * d)


def soar_assign(n: int, c: int, d: int) -> Work:
    """The SOAR spill of n rows: rows, unit residuals, primaries and the
    codebook read, an id and a loss written a row; ⟨x, c⟩ and ⟨r̂, c⟩ for
    every centroid, 4·n·c·d product operations."""
    return Work(2 * n * d * 4 + n * 4 + c * d * 4 + n * 8, mm_ops=4.0 * n * c * d)
