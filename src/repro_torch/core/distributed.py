"""Multi-device search (PyTorch port of `repro/core/distributed.py`).

Ported so far: `make_replicated_search`, the data-parallel replica
fan-out of DESIGN.md §3.12. The full packed index is copied to every
device and the query batch is split row-wise over them — the dual of the
shard-parallel search, which splits the database and replicates the
queries (that half of the JAX module, a `torch.distributed` port, comes
later). There are no collectives: each replica runs the single-device
pipeline (`search_jit_batched`) on its own rows, and the results are
concatenated on the first device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.search import PackedIVF, search_jit_batched
from repro_torch.quant.pq import PQCodebook
from repro_torch.utils import as_tensor


def packed_to(packed: PackedIVF, device: torch.device) -> PackedIVF:
    """A PackedIVF's tensors and router on `device` (the same tensors when
    they already lie there)."""
    def mv(t):
        return None if t is None else t.to(device)
    return PackedIVF(
        mv(packed.centroids), mv(packed.part_ids), mv(packed.part_codes),
        mv(packed.sizes), mv(packed.extent),
        None if packed.pq is None else PQCodebook(packed.pq.centers.to(device)),
        mv(packed.rerank),
        None if packed.router is None else packed.router.to(device))


def make_replicated_search(devices: Sequence, *, top_t: int, final_k: int,
                           rerank_budget: int = 256, multiplicity: int = 2,
                           with_filter: bool = False, escalate: bool = True,
                           params=None, bq: int = 128,
                           tile_rows: Optional[int] = None):
    """Replica fan-out over `devices` (torch devices or their names; one
    device may appear twice). Returns fn(PackedIVF, Q[, filter]) →
    (ids, scores) on the first device; Q's row count must be divisible by
    the number of replicas (serving callers get this from
    `pad_queries(..., multiple=R)`).

    Replica r takes rows [r·L, (r+1)·L) of Q (L = nq / R) and runs
    `search_jit_batched` on its own copy of the index in tiles of `bq`
    queries, each run at `tile_rows` rows when given. With the same `bq`
    and `tile_rows` as the single-device path, every query is searched at
    the same shapes as there, so results are the same bits.

    The copies are made once and reused while the caller passes the same
    PackedIVF object: `MutableIVF.pack()` returns a new one after every
    mutation that changes a slot (a delta or a full repack), and a soft
    removal changes only the filter, which travels with each call. The
    cache holds the snapshot it copied, so its identity is never reused.

    `params`: an optional serve/api.SearchParams overriding k / top_t /
    rerank_budget / escalate. with_filter=True: fn takes a trailing (n,)
    uint8 bitmap over global ids (a tenant bitmap), copied to each replica
    with the call.

    Degraded mode is not a mask here: replicas hold disjoint query rows,
    so dropping one would lose its queries' answers. The serving front-end
    falls back to the single-device path when a replica dispatch fails
    (serve/frontend.py).
    """
    if params is not None:
        p = params.validate(default_top_t=top_t, default_rerank=rerank_budget)
        top_t, final_k = p.top_t, p.k
        rerank_budget, escalate = p.rerank_budget, p.escalate
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("make_replicated_search needs at least one device")
    R = len(devs)
    cache: dict = {"src": None, "copies": None}

    def replicas(packed: PackedIVF):
        if cache["src"] is not packed:
            cache["copies"] = [packed_to(packed, d) for d in devs]
            cache["src"] = packed
        return cache["copies"]

    def fn(packed: PackedIVF, Q, filt=None):
        if with_filter != (filt is not None):
            raise TypeError("pass a filter exactly when with_filter=True")
        Q = as_tensor(Q, packed.centroids.device, torch.float32)
        nq = Q.shape[0]
        if nq % R:
            raise ValueError(f"{nq} query rows do not split over {R} replicas")
        L = nq // R
        outs = []
        for r, (dev, copy) in enumerate(zip(devs, replicas(packed))):
            f = None if filt is None else as_tensor(filt, dev)
            outs.append(search_jit_batched(
                copy, Q[r * L:(r + 1) * L].to(dev), top_t=top_t,
                final_k=final_k, rerank_budget=rerank_budget, bq=bq,
                multiplicity=multiplicity, filter=f, escalate=escalate,
                tile_rows=tile_rows))
        out_dev = devs[0]
        return (torch.cat([o[0].to(out_dev) for o in outs]),
                torch.cat([o[1].to(out_dev) for o in outs]))

    return fn
