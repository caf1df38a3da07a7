"""Serving engines (PyTorch port of `repro/serve/engine.py`): LM decode
(prefill + greedy decode over the model zoo) and online ANN serving over a
mutable SOAR index (DESIGN.md §3.7).

`ServeEngine` prefills a batch of prompts and decodes greedily on the
card (or on the CPU when asked). It casts the big group weights to the
compute dtype once, where JAX casts them on every call, and refuses an
encoder-only config when it is built (JAX fails later, inside the decode
step).

`AnnEngine` adds, removes and searches against a live `MutableIVF` on the
card: `search` serves from the index's cached packed snapshot through the
fixed-budget engine (`search_jit_batched`, or over several devices for
the front-end's replica fan-out), and mutations bring that snapshot in
step on the next search. The edge is numpy, as in the JAX package:
queries come in as arrays, ids and scores go out as arrays.
`save` / `open` snapshot and reopen the whole serving state, with an
optional mutation log (DESIGN.md §3.11), in the JAX package's format.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import faults
from repro_torch.ckpt.index_store import load_snapshot, save_snapshot
from repro_torch.ckpt.wal import MutationWAL
from repro_torch.core.distributed import make_replicated_search
from repro_torch.core.mutable import MutableIVF
from repro_torch.core.search import pad_queries, search_jit_batched
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import tree_map
from repro_torch.serve.api import (DEFAULT_BQ, DEFAULT_RERANK_BUDGET,
                                   DEFAULT_TOP_T, SearchParams, SearchResult,
                                   _positive_int, validate_queries)
from repro_torch.spans import span, timed, wait
from repro_torch.utils import Device, as_tensor, resolve_device


def make_serve_step(cfg: ModelConfig):
    """fn(params, token (B,1), caches, index) → (next_token (B,1), caches);
    the caches are updated in place."""

    def serve_step(params, token, caches, index: int):
        logits, caches = T.decode_step(params, token, caches, index, cfg)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return nxt[:, None], caches

    return serve_step


def make_prefill_step(cfg: ModelConfig, max_seq: int):
    def prefill_step(params, inputs):
        return T.prefill(params, inputs, cfg, max_seq=max_seq)
    return prefill_step


class ServeEngine:
    """Batched greedy-decoding engine.

    params: a `Transformer` or its parameter tree. The engine runs on
    `device` (CUDA unless the caller passes "cpu") and keeps its own tree
    there, with the big group weights cast once to the compute dtype.
    """

    def __init__(self, cfg: ModelConfig, params, max_seq: int = 256,
                 device: Device = None):
        if not cfg.has_decode:
            raise ValueError(f"{cfg.name}: an encoder-only config has no "
                             "decode step")
        self.cfg = cfg
        self.max_seq = max_seq
        self.device = resolve_device(device)
        tree = params.param_tree() if isinstance(params, T.Transformer) else params
        with torch.no_grad():
            tree = tree_map(lambda a: a.detach().to(self.device), tree)
            tree["groups"] = T.cast_big_params(tree["groups"], cfg)
        self.params = tree
        self._prefill = make_prefill_step(cfg, max_seq)
        self._step = make_serve_step(cfg)

    @torch.inference_mode()
    def generate(self, inputs: dict, n_new: int, timings: Optional[dict] = None):
        """inputs: {"tokens": (B, S)} (+ "patches" for vlm), arrays or
        tensors. Greedy decode → (B, n_new) int32 token ids on the
        engine's device; the argmax runs over the padded vocab.

        timings: if a dict, it receives "prefill_s" and "step_s" (a list,
        one per decode step), each on the host clock to the end of its
        device work (the device is synchronised after each). The prefill
        and each step are the spans "lm.prefill" and "lm.step"
        (`repro_torch.spans`)."""
        inputs = {k: as_tensor(v, self.device) for k, v in inputs.items()}
        if timings is not None:
            timings.pop("prefill_s", None)   # this call's prefill alone
            wait(self.device)                # earlier queued work is not the prefill's
        with timed("lm.prefill", timings, "prefill_s", self.device):
            logits, caches = self._prefill(self.params, inputs)
            tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
        prefix = (self.cfg.n_prefix_embeds
                  if self.cfg.frontend == "vision" else 0)
        start = inputs["tokens"].shape[1] + prefix
        out = [tok]
        for i in range(n_new - 1):
            with timed("lm.step", timings, "step_s", self.device, append=True):
                tok, caches = self._step(self.params, tok, caches, start + i)
                out.append(tok)
        return torch.cat(out, dim=1)


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
        self._replicas: dict = {}     # search keywords, devices → replica fn

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
               filter_ids=None, filter_mask=None, escalate=True,
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

    def search_request(self, Q, params: Optional[SearchParams] = None, *,
                       _filter_dev=None, _devices=None) -> SearchResult:
        """Structured entry point: (nq, d) queries + SearchParams →
        SearchResult (numpy ids and scores); the one place a served
        request becomes a tiled search.

        Validation runs through `SearchParams.validate()` and
        `validate_queries`. The queries are padded with zero rows to a
        power-of-two bucket (`pad_queries`: at least 8, at most `bq`) and
        the pad rows' results dropped, as in the JAX package, so a query
        is padded alike whether it comes alone or inside a coalesced
        batch; every tile then runs at `bq` rows (`tile_rows`), which makes
        a query's bits on the card independent of what shares its tile
        (coalesced ≡ solo), and pad rows never escalate (`queries`). The
        router clamps top_t. `_filter_dev` and `_devices` are the
        front-end's seams. `_filter_dev`: a pre-composed device uint8
        bitmap at the capacity width (tenant ∧ alive, cached by its
        TenantFilterBank) that replaces `serving_filter`; it escalates as
        `params.escalate` says. `_devices`: the replica branch, the batch
        padded to a multiple of their count too and split row-wise over
        them by a `make_replicated_search` closure cached by the search's
        keywords and the devices, with the local branch's bits. The fault
        point "replica:dispatch" fires once a call there, "engine:search"
        once a local call with queries. `engine_us` runs from the snapshot
        to the results on the host, whose copy waits for the device.

        The call is the span "engine.search_request" (counts: `queries`,
        `padded_rows`, the rows its tiles run, and `tiles`), with children
        "engine.prepare" (validation, the filter, the snapshot),
        "engine.copy_in" (padding and the copy to the device), the search's
        tiles and "engine.copy_out" (`repro_torch.spans`).
        """
        with span("engine.search_request") as req:
            with span("engine.prepare"):
                if _devices is not None:
                    faults.serve_point("replica:dispatch")
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
                if _devices is None:
                    faults.serve_point("engine:search")
                if _filter_dev is not None:
                    filt, escalate = _filter_dev, p.escalate
                else:
                    filt, escalate = self.index.serving_filter(
                        mask=p.filter_mask, ids=p.filter_ids, escalate=p.escalate)
                t0 = time.perf_counter()
                packed = self.index.pack()
            R = 1 if _devices is None else len(_devices)
            with span("engine.copy_in"):
                Qp, nq, bq = pad_queries(Q, self.bq, multiple=R)
                Qd = as_tensor(Qp, packed.centroids.device, torch.float32)
            tiles = R * -(-(Qp.shape[0] // R) // bq)
            req.count(queries=nq, padded_rows=tiles * self.bq, tiles=tiles)
            kw = dict(top_t=p.top_t, final_k=p.k,
                      rerank_budget=max(p.rerank_budget, p.k), bq=bq,
                      multiplicity=self.index.dedup_multiplicity,
                      escalate=escalate, tile_rows=self.bq)
            if _devices is None:
                ids, vals = search_jit_batched(packed, Qd, filter=filt, queries=nq, **kw)
            else:
                key = (tuple(_devices), filt is not None, *kw.values())
                if key not in self._replicas:
                    self._replicas[key] = make_replicated_search(
                        _devices, with_filter=filt is not None, **kw)
                ids, vals = self._replicas[key](packed, Qd, filt, queries=nq)
            with span("engine.copy_out"):
                ids, vals = ids[:nq].cpu().numpy(), vals[:nq].cpu().numpy()
            return SearchResult(
                ids, vals, engine_us=(time.perf_counter() - t0) * 1e6,
                batch_size=nq, escalated=bool(escalate and filt is not None),
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
