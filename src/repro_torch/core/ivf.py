"""Inverted-file (IVF) index with spilled assignments: layout and assembly
(PyTorch port of `repro/core/ivf.py`).

Layout follows the paper's memory model (§3.5, Figure 5): centroids once;
per assignment (duplicated under spilling) a point id and the PQ code of
the residual to that assignment's centroid; per point the f32 rerank row.
Partitions are CSR-contiguous (starts / point_ids). Every array of an
`IVFIndex` is a tensor on the index's device.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.quant.pq import (PQ_TRAIN_SAMPLE, PQCodebook, _encode_block,
                                  _sample_rows, train_pq)

ENCODE_CHUNK = 16_384      # assignments per residual-encode step


@dataclass
class IVFIndex:
    centroids: torch.Tensor            # (c, d) f32
    starts: torch.Tensor               # (c+1,) int64 CSR partition offsets
    point_ids: torch.Tensor            # (n_assign,) int32
    codes: Optional[torch.Tensor]      # (n_assign, m) uint8 residual PQ codes
    pq: Optional[PQCodebook]           # shared residual codebook
    rerank_f32: torch.Tensor           # (n, d) f32
    assignments: torch.Tensor          # (n, a) int32 — column 0 primary
    n_points: int
    spill_mode: str                    # "none" | "naive" | "soar"
    lam: float
    router: Optional[object] = None    # probe router (core/router.py); None → flat

    @property
    def n_assignments(self) -> int:
        return int(self.point_ids.shape[0])

    @property
    def n_partitions(self) -> int:
        return int(self.centroids.shape[0])

    def partition_sizes(self) -> torch.Tensor:
        return torch.diff(self.starts)


@contextmanager
def _phase(timings: Optional[dict], name: str, device: torch.device):
    """Add the block's wall seconds to timings[name] (no-op when timings is
    None). On a CUDA device the block's queued work is waited for, so a
    phase is charged with its own device time."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if timings is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0


def _csr_from_assignments(assignments: torch.Tensor, c: int):
    """(n, a) assignment matrix → CSR (starts, point_ids, order).

    A stable sort of the flat partition ids is exactly the counting-sort
    permutation of `repro/core/ivf.py::_stable_counting_sort`.
    """
    n, a = assignments.shape
    flat = assignments.reshape(-1).to(torch.int64)
    order = torch.sort(flat, stable=True).indices
    point_ids = torch.div(order, a, rounding_mode="floor").to(torch.int32)
    starts = torch.zeros(c + 1, dtype=torch.int64, device=assignments.device)
    starts[1:] = torch.cumsum(torch.bincount(flat, minlength=c), 0)
    return starts, point_ids, order


def finalize_ivf(gen: torch.Generator, X: torch.Tensor, C: torch.Tensor,
                 assignments: torch.Tensor, *, pq_subspaces: int = 0,
                 rerank: str = "f32", spill_mode: str = "soar", lam: float = 1.0,
                 pq: Optional[PQCodebook] = None,
                 timings: Optional[dict] = None, router=None) -> IVFIndex:
    """CSR + residual PQ + rerank assembly.

    Residuals to the centroid of each assignment are gathered, subtracted
    and encoded on the device, ENCODE_CHUNK assignments at a time (the
    fused route of the JAX package). With `pq` given the codebook is frozen
    and only encoding runs; otherwise it trains on a sample of residuals.
    `router` is stored on the index as it is.
    """
    if rerank != "f32":
        raise NotImplementedError(f"rerank={rerank!r}: only 'f32' is ported")
    dev = X.device
    with _phase(timings, "csr", dev):
        assignments = assignments.to(torch.int32)
        starts, point_ids, order = _csr_from_assignments(assignments, C.shape[0])
    codes = None
    if pq is not None or pq_subspaces > 0:
        flat_part = assignments.reshape(-1).to(torch.int64)[order]
        pids = point_ids.to(torch.int64)
        if pq is None:
            with _phase(timings, "pq_train", dev):
                na = pids.shape[0]
                if na > PQ_TRAIN_SAMPLE:   # train_pq's own sample, drawn here
                    sel = _sample_rows(gen, na, PQ_TRAIN_SAMPLE).to(dev)
                    res = X[pids[sel]] - C[flat_part[sel]]
                else:
                    res = X[pids] - C[flat_part]
                pq = train_pq(gen, res, pq_subspaces)
        with _phase(timings, "encode", dev):
            m, _, s = pq.centers.shape
            codes = torch.empty((pids.shape[0], m), dtype=torch.uint8, device=dev)
            for i0 in range(0, pids.shape[0], ENCODE_CHUNK):
                res = (X[pids[i0:i0 + ENCODE_CHUNK]]
                       - C[flat_part[i0:i0 + ENCODE_CHUNK]])
                codes[i0:i0 + res.shape[0]] = _encode_block(
                    pq.centers, res.reshape(-1, m, s))
    return IVFIndex(centroids=C, starts=starts, point_ids=point_ids, codes=codes,
                    pq=pq, rerank_f32=X, assignments=assignments,
                    n_points=int(X.shape[0]), spill_mode=spill_mode, lam=lam,
                    router=router)
