"""Online ANN serving over a mutable SOAR index (PyTorch port of the ANN
half of `repro/serve/engine.py`, DESIGN.md §3.7).

`AnnEngine` adds, removes and searches against a live `MutableIVF` on the
card: `search` serves from the index's cached packed snapshot through the
fixed-budget engine (`search_jit_batched`), and mutations bring that
snapshot in step on the next search. The edge is numpy, as in the JAX
package: queries come in as arrays, ids and scores go out as arrays.
`save` / `open` snapshot and reopen the whole serving state, with an
optional mutation log (DESIGN.md §3.11), in the JAX package's format.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

from repro_torch import faults
from repro_torch.ckpt.index_store import load_snapshot, save_snapshot
from repro_torch.ckpt.wal import MutationWAL
from repro_torch.core.mutable import MutableIVF
from repro_torch.core.router import clamp_top_t
from repro_torch.core.search import search_jit_batched
from repro_torch.serve.api import (DEFAULT_BQ, DEFAULT_RERANK_BUDGET,
                                   DEFAULT_TOP_T, SearchParams, SearchResult,
                                   _positive_int, validate_queries)
from repro_torch.utils import Device


class AnnEngine:
    """Online ANN serving engine over a mutable SOAR index.

    Point ids returned by `add` are stable handles for `remove` and for
    joining search results back to caller-side payloads.
    """

    def __init__(self, index: MutableIVF, *, top_t: int = DEFAULT_TOP_T,
                 rerank_budget: int = DEFAULT_RERANK_BUDGET,
                 bq: int = DEFAULT_BQ):
        self.index = index
        self.top_t = _positive_int("top_t", top_t)
        self.rerank_budget = _positive_int("rerank_budget", rerank_budget)
        self.bq = _positive_int("bq", bq)

    @classmethod
    def build(cls, gen, X, n_partitions: int, *, spill_mode: str = "soar",
              lam: float = 1.0, pq_subspaces: int = 0,
              top_t: int = DEFAULT_TOP_T,
              rerank_budget: int = DEFAULT_RERANK_BUDGET,
              bq: int = DEFAULT_BQ, router=None, router_kw=None,
              device: Device = None, **build_kw) -> "AnnEngine":
        """Sharded build (core/build.py) → serving engine, on `device`
        (CUDA unless the caller passes "cpu"). router: None (flat probe),
        "flat", "tree" or a router instance, as in `build_ivf_sharded`."""
        idx = MutableIVF.build(gen, X, n_partitions, spill_mode=spill_mode,
                               lam=lam, pq_subspaces=pq_subspaces,
                               router=router, router_kw=router_kw,
                               device=device, **build_kw)
        return cls(idx, top_t=top_t, rerank_budget=rerank_budget, bq=bq)

    @property
    def n_alive(self) -> int:
        return self.index.n_alive

    def add(self, X) -> np.ndarray:
        """Insert vectors → their stable ids (int32 numpy array)."""
        faults.serve_point("engine:add")
        return self.index.add(X).cpu().numpy()

    def remove(self, ids, hard: bool = True) -> int:
        """Delete points. hard=False leaves slots in place and serves the
        tombstones through the standing filter bitmap — see
        MutableIVF.remove."""
        faults.serve_point("engine:remove")
        return self.index.remove(ids, hard=hard)

    def search(self, Q, k: int = 10, top_t: Optional[int] = None,
               filter_ids=None, filter_mask=None, escalate: bool = True,
               sanitize: bool = False):
        """(nq, d) queries → (ids (nq, k) int32, scores (nq, k)), numpy.

        A shim over `search_request` with the fields as keywords; results
        equal those of the structured call. filter_ids / filter_mask
        restrict the search to a subset of live points and compose with
        the standing soft-tombstone filter.
        """
        r = self.search_request(Q, SearchParams(
            k=k, top_t=top_t, filter_ids=filter_ids,
            filter_mask=filter_mask, escalate=escalate, sanitize=sanitize))
        return r.ids, r.scores

    def search_request(self, Q, params: Optional[SearchParams] = None) -> SearchResult:
        """Structured entry point: (nq, d) queries + SearchParams →
        SearchResult (numpy ids and scores).

        Validation runs through `SearchParams.validate()` and
        `validate_queries`. `engine_us` runs from the snapshot to the results on the host,
        whose copy waits for the device.
        """
        p = (params or SearchParams()).validate(
            default_top_t=self.top_t, default_rerank=self.rerank_budget)
        Q = validate_queries(Q, self.index.centroids.shape[1],
                             sanitize=p.sanitize)
        epoch = self.index._alive_epoch
        if Q.shape[0] == 0:
            return SearchResult(np.empty((0, p.k), np.int32),
                                np.empty((0, p.k), np.float32),
                                epoch=epoch, tenant=p.tenant,
                                deadline_ms=p.deadline_ms)
        faults.serve_point("engine:search")
        filt, escalate = self.index.serving_filter(
            mask=p.filter_mask, ids=p.filter_ids, escalate=p.escalate)
        t0 = time.perf_counter()
        ids, vals = search_jit_batched(
            self.index.pack(), Q,
            top_t=clamp_top_t(p.top_t, self.index.centroids.shape[0]),
            final_k=p.k, rerank_budget=max(p.rerank_budget, p.k),
            bq=self.bq, multiplicity=1 + max(self.index.n_spills, 1),
            filter=filt, escalate=escalate)
        ids, vals = ids.cpu().numpy(), vals.cpu().numpy()
        return SearchResult(
            ids, vals, engine_us=(time.perf_counter() - t0) * 1e6,
            batch_size=Q.shape[0], escalated=bool(escalate and filt is not None),
            epoch=epoch, tenant=p.tenant, deadline_ms=p.deadline_ms)

    # ---------------------------------------------------------- durability
    def save(self, path: str, *, extra: Optional[dict] = None,
             extra_arrays: Optional[dict] = None):
        """Atomic, versioned snapshot of the whole serving state — the
        index (codebooks, router, partitions, tombstones, wal_seq) and the
        engine config — under `path`. If a log is attached it is rotated
        afterwards: the snapshot's wal_seq covers every record, and
        sequence numbers go on from it, so a crash between the snapshot's
        commit and the rotation is benign. `extra` (JSON-able) and
        `extra_arrays` (name → array) ride the snapshot for layers above
        the engine."""
        os.makedirs(path, exist_ok=True)
        meta = {"engine": {"top_t": self.top_t,
                           "rerank_budget": self.rerank_budget,
                           "bq": self.bq}}
        meta.update(extra or {})
        save_snapshot(os.path.join(path, "index"), self.index,
                      extra=meta, extra_arrays=extra_arrays)
        if self.index._wal is not None:
            self.index._wal.rotate(self.index.wal_seq)

    @classmethod
    def open(cls, path: str, *, wal: bool = False, fsync: str = "always",
             device: Device = None) -> "AnnEngine":
        """Reopen a saved engine on `device` (CUDA unless the caller passes
        "cpu"): load the latest valid snapshot (the atomic swap's `.old`
        fallback included) and replay the log's committed records past its
        wal_seq, so recovery lands bit for bit on the last committed
        state. `wal=True` (or a log already on disk) leaves the log
        attached, so every later mutation is logged; `fsync` is its
        policy ("always" | "never")."""
        idx, extra = load_snapshot(os.path.join(path, "index"),
                                   expect_kind="MutableIVF", device=device)
        cfg = dict(extra.get("engine", {}))
        eng = cls(idx, top_t=int(cfg.get("top_t", DEFAULT_TOP_T)),
                  rerank_budget=int(cfg.get("rerank_budget",
                                            DEFAULT_RERANK_BUDGET)),
                  bq=int(cfg.get("bq", DEFAULT_BQ)))
        wal_path = os.path.join(path, "wal.log")
        if wal or os.path.exists(wal_path):
            idx.attach_wal(MutationWAL(wal_path, fsync=fsync,
                                       start_seq=idx.wal_seq))
        return eng
