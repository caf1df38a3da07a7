"""SOAR-backed kNN attention memory (PyTorch port of
`repro/serve/knn_memory.py`): the paper's technique as an LM-serving
feature (the paper cites memorizing transformers as a driving
application).

For very long contexts, instead of attending densely over the whole KV
cache, each query retrieves its top-k keys from a SOAR IVF index built over
the cached keys and attends only to those. Attention is MIPS over keys —
the workload SOAR accelerates — and the spilled assignment rescues the
high-⟨q, r⟩ keys a single-partition index misses, which for attention are
the high-score keys.

The index is mutable (core/mutable.py): decode appends fresh KV pairs with
`add` (incremental SOAR assignment against the frozen codebook, the vq and
soar kernels on the card) and cache eviction tombstones them with
`remove`. The whole memory lives on the index's device: `values` and
`segments` are tensors grown with the index's id space, the keys are the
index's own rerank rows, and retrieval filters are composed there.
`retrieve` / `retrieve_request` / `attend` take and return numpy, as
AnnEngine does at its edge; the softmax and the weighted sum of `attend`
run in torch on the device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.ckpt.index_store import load_snapshot, save_snapshot
from repro_torch.core.ivf import build_ivf
from repro_torch.core.mutable import MutableIVF, _grow_rows
from repro_torch.core.search import pad_queries, search_jit_batched, search_numpy
from repro_torch.quant.int8 import rerank_f32
from repro_torch.serve.api import (DEFAULT_TOP_T, SearchParams, SearchResult,
                                   validate_queries)
from repro_torch.utils import Device, as_tensor, resolve_device


def _labels(segment, n: int, device: torch.device) -> torch.Tensor:
    """A segment label (int) or one per row → (n,) int32 on `device`."""
    return as_tensor(segment, device, torch.int32).expand(n).clone()


@dataclass
class KNNMemory:
    """Per-(layer, head) SOAR index over cached keys.

    `engine` picks the retrieval path: "numpy" (the host engine
    `search_numpy` over the CSR snapshot, which the port runs in torch on
    the index's device) or "jit" (the candidate-local fixed-budget
    pipeline over the packed snapshot, in tiles). Both dedup spilled
    candidates window-locally, so retrieval cost never scales with the
    number of cached keys beyond the probed partitions.

    `values` is a capacity buffer grown geometrically in step with the
    index's id space (decode appends one position per step — appends must
    be amortized O(batch), not O(n_total)); rows at or beyond
    `index.n_total` are unused capacity. `segments` holds an int32 label
    per id, -1 on unused capacity.

    Retrieval takes kNN-attention-shaped subset filters (DESIGN.md §3.9):
    a `recency` window (ids are append-ordered, so the last W positions are
    the id range [n_total - W, n_total)), a per-sequence `segment` label
    recorded at `add` time (sequences sharing one memory must not attend
    across each other), and a raw `filter_mask`. All compose with each
    other and with the index's standing tombstone filter, on both engines.
    """
    index: MutableIVF
    values: torch.Tensor    # (>= n_total, hd) f32 capacity buffer, see above
    engine: str = "numpy"
    segments: Optional[torch.Tensor] = None   # (>= n_total,) int32 label per id
    # probe budget when a retrieve passes none: the shared serving default
    top_t: int = DEFAULT_TOP_T

    @classmethod
    def build(cls, keys, values, n_partitions: Optional[int] = None,
              lam: float = 1.0, spill_mode: str = "soar", seed: int = 0,
              engine: str = "numpy", segment=0, router=None, router_kw=None,
              device: Device = None) -> "KNNMemory":
        """Build over (n, hd) keys and values (numpy arrays or tensors) on
        `device` (CUDA unless the caller passes "cpu"): `build_ivf` with
        six k-means iterations and no PQ stage (the window is scored
        exactly), c = max(4, n // 256) partitions unless given. `segment`
        labels the keys: one label, or one per row. router: probe-stage
        router spec (core/router.py) — "tree" trains a two-level router,
        which every retrieve on both engines then probes through."""
        dev = resolve_device(device)
        keys = as_tensor(keys, dev, torch.float32)
        n = keys.shape[0]
        c = max(4, n // 256) if n_partitions is None else int(n_partitions)
        idx = build_ivf(torch.Generator().manual_seed(seed), keys, c,
                        spill_mode=spill_mode, lam=lam, train_iters=6,
                        router=router, router_kw=router_kw, device=dev)
        return cls(MutableIVF.from_index(idx),
                   as_tensor(values, dev, torch.float32).clone(),
                   engine=engine, segments=_labels(segment, n, dev))

    @property
    def device(self) -> torch.device:
        return self.index.device

    @property
    def keys(self) -> torch.Tensor:
        """Cached keys by id — the index's rerank rows are the key store
        (f32; int8 rows dequantized)."""
        return rerank_f32(self.index.rerank)[:self.index.n_total]

    def add(self, keys, values, segment=0) -> np.ndarray:
        """Append fresh KV pairs (e.g. newly decoded positions); returns
        their stable ids (int32 numpy). Assignment is incremental — the
        codebook trained at build time stays frozen. `segment` labels the
        batch (one label, or one per row) for per-sequence retrieval."""
        dev = self.device
        keys = as_tensor(keys, dev, torch.float32)
        values = as_tensor(values, dev, torch.float32)
        keys = keys[None] if keys.dim() == 1 else keys
        values = values[None] if values.dim() == 1 else values
        if keys.shape[0] != values.shape[0]:
            raise ValueError(f"{keys.shape[0]} keys but {values.shape[0]} values")
        ids = self.index.add(keys)
        rows = ids.to(torch.int64)
        nt = self.index.n_total
        self.values = _grow_rows(self.values, nt, 0.0)
        self.values[rows] = values
        if self.segments is None:
            self.segments = torch.zeros(nt, dtype=torch.int32, device=dev)
        self.segments = _grow_rows(self.segments, nt, -1)
        self.segments[rows] = _labels(segment, rows.shape[0], dev)
        return ids.cpu().numpy()

    def remove(self, ids, hard: bool = True) -> int:
        """Evict cached positions (tombstone; ids stay stable). hard=False
        defers slot reclamation to the standing filter bitmap — the cheap
        choice for per-step eviction inside a decode loop."""
        return self.index.remove(ids, hard=hard)

    def _serving_filter(self, recency, segment, filter_mask):
        """Compose recency window / segment label / user bitmap with the
        index's standing tombstone filter on the device (uint8 at the
        capacity width); None when retrieval can stay on the unfiltered
        fast path."""
        if (recency is None and segment is None and filter_mask is None
                and not self.index.n_soft_deleted):
            return None
        out = self.index.filter_bitmap(mask=filter_mask)
        nt = self.index.n_total
        if recency is not None:
            out[:max(0, nt - int(recency))] = 0
        if segment is not None:
            seg = torch.full((out.shape[0],), -1, dtype=torch.int32,
                             device=out.device)
            if self.segments is not None:
                w = min(self.segments.shape[0], out.shape[0])
                seg[:w] = self.segments[:w]
            out &= (seg == segment).to(torch.uint8)
        return out

    def retrieve(self, q: np.ndarray, k: int = 32,
                 top_t: Optional[int] = None,
                 recency: Optional[int] = None,
                 segment: Optional[int] = None,
                 filter_mask: Optional[np.ndarray] = None,
                 escalate: bool = True):
        """q: (nq, hd) queries → (ids (nq, k), keys, values), numpy.

        A shim over `retrieve_request` with the fields as keywords.
        top_t=None resolves to `self.top_t`. recency: only the last
        `recency` cached positions; segment: only positions added with
        that label; filter_mask: an arbitrary (n_total,)-prefix bitmap.
        Any combination; escalate=False skips the thin-window re-probe.
        """
        r, K, V = self.retrieve_request(q, SearchParams(
            k=k, top_t=top_t, recency=recency, segment=segment,
            filter_mask=filter_mask, escalate=escalate))
        return r.ids, K, V

    def retrieve_request(self, q: np.ndarray,
                         params: Optional[SearchParams] = None):
        """Structured retrieval: (SearchResult, keys, values), numpy.

        The same validation path as AnnEngine.search_request
        (SearchParams.validate + validate_queries). `scores` on the result
        is None for the numpy engine (the host engine computes no final
        scores).
        """
        r, _, K, V = self._retrieve(q, params)
        return r, K.cpu().numpy(), V.cpu().numpy()

    def _retrieve(self, q, params: Optional[SearchParams]):
        """→ (SearchResult, validated queries, keys, values); keys and
        values as (nq, k, hd) tensors on the device."""
        p = (params or SearchParams()).validate(default_top_t=self.top_t)
        k, top_t = p.k, p.top_t
        recency, segment = p.recency, p.segment
        filter_mask, escalate = p.filter_mask, p.escalate
        q = validate_queries(q, self.index.centroids.shape[1],
                             sanitize=p.sanitize)
        vals = None
        if self.engine == "jit":
            if recency is None and segment is None and filter_mask is None:
                # standing soft-tombstone filter only: cached device
                # bitmap, and no escalation pass unless it is actually thin
                f, escalate = self.index.serving_filter(escalate=escalate)
            else:
                f = self._serving_filter(recency, segment, filter_mask)
            # pad to the bucket (at least 8, at most 128), as in the JAX
            # package: a ragged per-step nq is served at a few tile sizes
            qp, nq, bq = pad_queries(q, 128)
            ids, vals = search_jit_batched(
                self.index.pack(), qp, top_t=top_t, final_k=k,
                rerank_budget=max(4 * k, 64), bq=bq,
                multiplicity=self.index.dedup_multiplicity,
                filter=f, escalate=escalate)
            ids, vals = ids[:nq], vals[:nq]
        else:
            filt = self._serving_filter(recency, segment, filter_mask)
            ids, _ = search_numpy(
                self.index.to_ivf_index(), q, top_t=top_t, final_k=k,
                filter_mask=(filt[:self.index.n_total]
                             if filt is not None else None),
                escalate=escalate)
        safe = ids.clamp(min=0).to(torch.int64)
        result = SearchResult(
            ids.cpu().numpy(), None if vals is None else vals.cpu().numpy(),
            batch_size=int(ids.shape[0]), escalated=bool(escalate),
            epoch=self.index._alive_epoch)
        return result, q, self.keys[safe], self.values[safe]

    # ---------------------------------------------------------- durability
    def save(self, path: str):
        """Atomic versioned snapshot of the whole memory — index (with
        tombstone state + router), value buffer, per-id segment labels,
        engine choice — in the JAX package's format (DESIGN.md §3.11)."""
        save_snapshot(path, self)

    @classmethod
    def open(cls, path: str, device: Device = None) -> "KNNMemory":
        """Reload a saved memory on `device` (CUDA unless the caller passes
        "cpu"); retrieval over the reopened object equals the saved one's
        bit for bit (integrity-checked load — CorruptSnapshotError on any
        torn or flipped byte)."""
        mem, _ = load_snapshot(path, expect_kind="KNNMemory", device=device)
        return mem

    def attend(self, q: np.ndarray, k: int = 32,
               top_t: Optional[int] = None,
               recency: Optional[int] = None, segment: Optional[int] = None,
               filter_mask: Optional[np.ndarray] = None,
               escalate: bool = True):
        """Approximate attention output for each query over retrieved keys.

        Returns (out (nq, hd) f32, ids), numpy. Softmax over the retrieved
        set only — the memorizing-transformer approximation — computed on
        the device. Filter kwargs as in `retrieve`.
        """
        r, q, K, V = self._retrieve(q, SearchParams(
            k=k, top_t=top_t, recency=recency, segment=segment,
            filter_mask=filter_mask, escalate=escalate))
        qt = torch.from_numpy(q).to(K.device)
        valid = torch.from_numpy(r.ids >= 0).to(K.device)
        logits = torch.einsum("qd,qkd->qk", qt, K) / math.sqrt(q.shape[-1])
        logits = logits.masked_fill(~valid, -1e30)
        w = torch.exp(logits - logits.amax(dim=1, keepdim=True))
        # hard-mask padding so a query with NO retrieved keys (e.g. after
        # full eviction) yields a zero output, not a uniform mix of row 0
        w = w * valid
        w = w / w.sum(dim=1, keepdim=True).clamp(min=1e-30)
        return torch.einsum("qk,qkd->qd", w, V).cpu().numpy(), r.ids


def exact_topk_attention(q, keys, values, k: int, device: Device = None):
    """Oracle: attention over the true top-k keys (for quality evaluation).
    Inputs are numpy arrays or tensors; the work runs on keys' device when
    it is a tensor, else on `device` (CUDA unless the caller passes "cpu").
    Returns (out (nq, hd) f32, ids (nq, k)), numpy; the ids of a row come
    in descending score order."""
    dev = keys.device if isinstance(keys, torch.Tensor) else resolve_device(device)
    q = as_tensor(q, dev, torch.float32)
    keys = as_tensor(keys, dev, torch.float32)
    values = as_tensor(values, dev, torch.float32)
    logits = q @ keys.T / math.sqrt(q.shape[-1])
    sel, idx = torch.topk(logits, k, dim=1)
    w = torch.exp(sel - sel[:, :1])
    w = w / w.sum(dim=1, keepdim=True)
    out = torch.einsum("qk,qkd->qd", w, values[idx])
    return out.cpu().numpy(), idx.cpu().numpy()
