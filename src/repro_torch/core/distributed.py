"""Distributed SOAR serving (PyTorch port of `repro/core/distributed.py`):
the database sharded, queries replicated, a local IVF search per shard and
a global top-k merge; and its dual, the replica fan-out.

Shard-parallel search (DESIGN.md §3.5):
- each shard owns n/D vectors and its own VQ codebook, spilled IVF, PQ
  codebook and (optionally) tree router: the build is shard-local
  (`build_sharded_ivf(_pq)`, `make_sharded_assign`);
- the shards' arrays are stacked over a leading shard dim D
  (`ShardedIVF`, `ShardedIVFPQ`, `ShardedTreeRouter`, filter stacks from
  `stack_filters` / `shard_filters`, (D,) uint8 health masks);
- a shard's local search is the single-device pass
  (`core/search.py::_search_pass`, through `search_jit_batched`) on a
  `PackedIVF` whose tensors are that shard's slice, probed by the shard's
  own router and never escalated; its ids are globalised by the shard's
  `local_base` (-1 stays -1), a down shard's rows become (-1, -inf), and
  the (D, nq, k) results merge into the global top k, ties to the lower
  shard as `jax.lax.top_k` gives. The collective moves O(nq·k·D) bytes,
  whatever the database size.

Placement. JAX's mesh and PartitionSpecs (`sharded_ivf_pspecs`,
`sharded_ivf_pq_pspecs`, `tree_router_pspecs`) have no torch object;
their counterpart is this rule, which both makers follow:
- in one process, `devices=[...]`: shard s is searched on
  devices[s % len(devices)] (one device may repeat; a shard that lies
  elsewhere is copied there at each call) and the merge runs on
  devices[0]. By default every shard is searched where the stack lies;
- under torch.distributed, `group=` an initialised process group of
  `world` ranks: rank r holds the contiguous block of D / world shards
  that starts at shard r·D/world (`local_shards` cuts it from a full
  stack), passes that block for every sharded argument and searches it
  on its own device(s) as above. `dist.all_gather` (the list form) brings
  every rank's (D/world, nq, k) ids and scores together in shard order,
  and every rank runs the same merge. The tensors go to the collective
  where they lie, whatever the backend: gloo's `all_gather` takes CUDA
  tensors as NCCL's does (checked on an H100 with torch 2.11; NCCL
  refuses two ranks on one card, gloo does not). The makers never
  initialise a process group. The port has one flat shard order where
  JAX may shard over several mesh axes.

Every local search runs its queries in tiles of TILE_ROWS rows, the last
tile padded, so a query's bits do not depend on nq (on the card cuBLAS
picks the rerank product's algorithm by row count) and no buffer grows
with nq; nothing on the search path has a dimension of the shard's size.

The replica fan-out (`make_replicated_search`, DESIGN.md §3.12) copies
the full packed index to every device and splits the query rows: no
collectives, each replica runs the single-device pipeline on its rows.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.build import build_ivf_sharded
from repro_torch.core.ivf import spill_plan
from repro_torch.core.mutable import MutableIVF
from repro_torch.core.router import FlatRouter, TreeRouter
from repro_torch.core.search import (PackedIVF, pack_ivf, search_jit_batched,
                                     slot_extent)
from repro_torch.kernels.soar_assign import assign_fused
from repro_torch.quant.int8 import rerank_f32
from repro_torch.quant.pq import PQCodebook
from repro_torch.utils import Device, as_tensor, topk_first

TILE_ROWS = 64      # query rows of every local-search tile


class ShardedIVF(NamedTuple):
    """Per-shard IVF tensors, stacked over a leading shard dim D."""
    centroids: torch.Tensor     # (D, c, d) f32
    part_ids: torch.Tensor      # (D, c, pmax) int32 local point ids, -1 pad
    sizes: torch.Tensor         # (D, c) int32
    rerank: torch.Tensor        # (D, n_local, d) f32, zero rows past a shard's own
    local_base: torch.Tensor    # (D,) int32 global id of each shard's local id 0

    def to(self, device) -> "ShardedIVF":
        return ShardedIVF(*(t.to(device) for t in self))


class ShardedIVFPQ(NamedTuple):
    """The PQ-scored variant (the paper's pipeline): per-assignment uint8
    codes in partition order, scored by probe id, so candidates are read
    as m bytes each instead of 4d. `extent` bounds the probe scorer as
    `PackedIVF.extent` does. Every shard's block of `part_codes` starts on
    16 bytes (the probe scorer's requirement), so when c·pmax·m is not a
    multiple of 16 the stack is a strided view with unused bytes between
    blocks; each block is contiguous."""
    centroids: torch.Tensor     # (D, c, d) f32
    part_ids: torch.Tensor      # (D, c, pmax) int32 local ids, -1 pad
    part_codes: torch.Tensor    # (D, c, pmax, m) uint8 PQ codes per assignment
    pq_centers: torch.Tensor    # (D, m, 16, s) f32 per-shard PQ codebook
    sizes: torch.Tensor         # (D, c) int32
    rerank: torch.Tensor        # (D, n_local, d) f32
    local_base: torch.Tensor    # (D,) int32
    extent: torch.Tensor        # (D, c) int32 last slot with an id >= 0, plus one

    def to(self, device) -> "ShardedIVFPQ":
        out = ShardedIVFPQ(*(t.to(device) for t in self))
        if out.part_codes is self.part_codes:
            return out
        return out._replace(part_codes=_aligned_codes(out.part_codes,
                                                      out.part_codes.device))


class ShardedTreeRouter(NamedTuple):
    """Per-shard TreeRouter tables, stacked over the leading shard dim D
    and padded to the common (S, cmax): pad supers are zero rows whose
    children are all -1, so choosing one gives only -inf candidates (a
    wasted route slot, never a wrong result)."""
    super_centroids: torch.Tensor   # (D, S, d) f32
    children: torch.Tensor          # (D, S, cmax) int32 local partitions, -1 pad
    child_centroids: torch.Tensor   # (D, S, cmax, d) f32

    def to(self, device) -> "ShardedTreeRouter":
        return ShardedTreeRouter(*(t.to(device) for t in self))


def _aligned_codes(tables, device) -> torch.Tensor:
    """Per-shard (c, pmax, m) uint8 tables (a list, or a (D, c, pmax, m)
    tensor) → a (D, c, pmax, m) stack on `device` whose every shard block
    starts on 16 bytes (the probe scorer reads a table in 16-byte chunks
    from its start; `kernels/pq_score.py`)."""
    c, pmax, m = tables[0].shape
    stride = -(-(c * pmax * m) // 16) * 16
    buf = torch.zeros(len(tables) * stride + 16, dtype=torch.uint8, device=device)
    out = buf.as_strided((len(tables), c, pmax, m), (stride, pmax * m, m, 1),
                         -buf.data_ptr() % 16)
    for s, t in enumerate(tables):
        out[s].copy_(t)
    return out


def stack_tree_routers(routers) -> ShardedTreeRouter:
    """Stack per-shard TreeRouters (each shard built with router="tree")
    into the envelope of the `with_router=True` search paths, on the
    first router's device."""
    S = max(r.n_super for r in routers)
    cmax = max(r.cmax for r in routers)
    d = routers[0].d
    D = len(routers)
    dev = routers[0].super_centroids.device
    SC = torch.zeros((D, S, d), dtype=torch.float32, device=dev)
    CH = torch.full((D, S, cmax), -1, dtype=torch.int32, device=dev)
    CC = torch.zeros((D, S, cmax, d), dtype=torch.float32, device=dev)
    for i, r in enumerate(routers):
        SC[i, :r.n_super] = r.super_centroids
        CH[i, :r.n_super, :r.cmax] = r.children
        CC[i, :r.n_super, :r.cmax] = r.child_centroids
    return ShardedTreeRouter(SC, CH, CC)


def _resolve_shard(idx):
    """Accept an IVFIndex or a (mutated) MutableIVF per shard."""
    return idx.to_ivf_index() if isinstance(idx, MutableIVF) else idx


def _stack_shards(indexes):
    """The shared stacker of `sharded_from_indexes(_pq)`: resolve mutable
    shards, pack, pad ids to the common pmax (-1) and rerank rows (f32;
    int8 rows dequantized) to the largest local id space (zero rows: a
    padded id is in no partition slot, so it is unreachable), and
    accumulate the global-id bases, on the first shard's device. Returns (packed, centroids, ids, sizes,
    rerank, bases), the last five stacked."""
    resolved = [_resolve_shard(i) for i in indexes]
    packed = [pack_ivf(i) for i in resolved]
    n_locals = [i.n_points for i in resolved]
    pmax = max(pk.part_ids.shape[1] for pk in packed)
    nmax = max(n_locals)
    dev = packed[0].centroids.device
    ids = torch.stack([F.pad(pk.part_ids.to(dev), (0, pmax - pk.part_ids.shape[1]),
                             value=-1) for pk in packed])
    rerank = torch.stack([F.pad(rerank_f32(pk.rerank).to(dev), (0, 0, 0, nmax - nl))
                          for pk, nl in zip(packed, n_locals)])
    cents = torch.stack([pk.centroids.to(dev) for pk in packed])
    sizes = torch.stack([pk.sizes.to(dev) for pk in packed])
    bases = torch.tensor(np.cumsum([0] + n_locals[:-1]), dtype=torch.int32,
                         device=dev)
    return packed, cents, ids, sizes, rerank, bases


def sharded_from_indexes(indexes) -> ShardedIVF:
    """Stack per-shard indexes (IVFIndex or MutableIVF) into a ShardedIVF:
    the refresh path after online mutation. Local ids keep their
    shard-stable values and globalise through the cumulative bases."""
    _, cents, ids, sizes, rerank, bases = _stack_shards(indexes)
    return ShardedIVF(cents, ids, sizes, rerank, bases)


def sharded_from_indexes_pq(indexes) -> ShardedIVFPQ:
    """Stack per-shard PQ indexes (IVFIndex or MutableIVF) into a
    ShardedIVFPQ: codes padded with zeros to the common pmax, each shard's
    own PQ codebook, and each partition's extent."""
    packed, cents, ids, sizes, rerank, bases = _stack_shards(indexes)
    pmax = ids.shape[2]
    dev = ids.device
    codes = _aligned_codes(
        [F.pad(pk.part_codes.to(dev), (0, 0, 0, pmax - pk.part_codes.shape[1]))
         for pk in packed], dev)
    pqcs = torch.stack([pk.pq.centers.to(dev) for pk in packed])
    return ShardedIVFPQ(cents, ids, codes, pqcs, sizes, rerank, bases,
                        slot_extent(ids))


def shard_generator(seed: int, shard: int) -> torch.Generator:
    """The random stream `build_sharded_ivf(_pq)` give shard `shard` of a
    build seeded `seed`: a torch.Generator seeded with the first 63 bits of
    numpy's SeedSequence((seed, shard)), the port's `jax.random.fold_in`
    (the streams differ from JAX's, so free builds agree by recall)."""
    state = np.random.SeedSequence((seed, shard)).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state) >> 1)


def _build_shards(seed, X, n_shards: int, n_partitions: int, device, **kw):
    n = X.shape[0]
    if n % n_shards:
        raise ValueError(f"{n} rows do not split into {n_shards} equal shards")
    nl = n // n_shards
    return [build_ivf_sharded(shard_generator(seed, s), X[s * nl:(s + 1) * nl],
                              n_partitions, device=device, **kw)
            for s in range(n_shards)]


def build_sharded_ivf(seed: int, X, n_shards: int, n_partitions: int,
                      spill_mode: str = "soar", lam: float = 1.0,
                      train_iters: int = 8, device: Device = None) -> ShardedIVF:
    """Split X (numpy array or tensor) row-wise into n_shards equal shards
    and build one spilled IVF per shard (`build_ivf_sharded`, streamed, so
    a shard's build holds O(shard tile) beyond its rows) with the
    generator `shard_generator(seed, s)`, on `device` (CUDA unless the
    caller passes "cpu"); returns their stack."""
    return sharded_from_indexes(_build_shards(
        seed, X, n_shards, n_partitions, device, spill_mode=spill_mode, lam=lam,
        train_iters=train_iters))


def build_sharded_ivf_pq(seed: int, X, n_shards: int, n_partitions: int,
                         pq_subspaces: int, spill_mode: str = "soar",
                         lam: float = 1.0, train_iters: int = 8,
                         device: Device = None) -> ShardedIVFPQ:
    """`build_sharded_ivf` with residual PQ codes of `pq_subspaces`
    subspaces per shard; returns the PQ-scored stack."""
    return sharded_from_indexes_pq(_build_shards(
        seed, X, n_shards, n_partitions, device, spill_mode=spill_mode, lam=lam,
        pq_subspaces=pq_subspaces, train_iters=train_iters))


def make_sharded_assign(devices: Sequence, *, spill_mode: str = "soar",
                        lam: float = 1.0, n_spills: int = 1, chunk: int = 8192):
    """Build-side fan-out: fn(X (n, d), C (c, d)) → (n, 1 + spills) int32
    assignments on the first device. X's rows split into len(devices)
    equal parts (one device may repeat; n must divide), part r assigned on
    devices[r] through `assign_fused` against its own copy of C, the parts
    concatenated. Assignment against a frozen codebook is row-independent,
    so the result equals one `assign_fused` call on every row; there are
    no collectives. `chunk` is JAX's and has no effect (the port's chunks
    are module constants)."""
    eff_lam, eff_spills = spill_plan(spill_mode, lam, n_spills)
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("make_sharded_assign needs at least one device")

    def fn(X, C):
        n = X.shape[0]
        if n % len(devs):
            raise ValueError(f"{n} rows do not split over {len(devs)} devices")
        L = n // len(devs)
        return torch.cat([
            assign_fused(as_tensor(X[r * L:(r + 1) * L], dev, torch.float32).contiguous(),
                         as_tensor(C, dev, torch.float32).contiguous(),
                         lam=eff_lam, n_spills=eff_spills).to(devs[0])
            for r, dev in enumerate(devs)])

    return fn


def abstract_sharded_ivf(n_shards: int, n_local: int, n_partitions: int,
                         pmax: int, d: int) -> ShardedIVF:
    """A ShardedIVF of tensors on the "meta" device (shapes and dtypes, no
    storage): the port's stand-in for JAX's ShapeDtypeStruct, for sizing
    a shard without allocating it."""
    def f(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    return ShardedIVF(
        f((n_shards, n_partitions, d), torch.float32),
        f((n_shards, n_partitions, pmax), torch.int32),
        f((n_shards, n_partitions), torch.int32),
        f((n_shards, n_local, d), torch.float32),
        f((n_shards,), torch.int32))


def abstract_sharded_ivf_pq(n_shards: int, n_local: int, n_partitions: int,
                            pmax: int, d: int, m: int) -> ShardedIVFPQ:
    """`abstract_sharded_ivf` for the PQ-scored stack (with its extent)."""
    a = abstract_sharded_ivf(n_shards, n_local, n_partitions, pmax, d)
    return ShardedIVFPQ(
        a.centroids, a.part_ids,
        torch.empty((n_shards, n_partitions, pmax, m), dtype=torch.uint8,
                    device="meta"),
        torch.empty((n_shards, m, 16, d // m), dtype=torch.float32, device="meta"),
        a.sizes, a.rerank, a.local_base,
        torch.empty((n_shards, n_partitions), dtype=torch.int32, device="meta"))


def _uint8(mask) -> torch.Tensor:
    """A bitmap (numpy array or tensor) as a flat uint8 tensor, on its own
    device (the CPU for numpy)."""
    t = mask if isinstance(mask, torch.Tensor) else torch.tensor(np.asarray(mask))
    return t.to(torch.uint8).reshape(-1)


def stack_filters(masks, n_local_max: Optional[int] = None) -> torch.Tensor:
    """Per-shard local-id filter bitmaps → (D, nmax) uint8, zero-padded, on
    the first mask's device. A padded local id is in no partition slot
    and a 0 bit only masks it again, so over-padding is harmless. Feed the
    result to the filtered search paths (sharded like the index)."""
    masks = [_uint8(m) for m in masks]
    nmax = int(max(m.shape[0] for m in masks) if n_local_max is None
               else n_local_max)
    out = torch.zeros((len(masks), nmax), dtype=torch.uint8, device=masks[0].device)
    for i, m in enumerate(masks):
        out[i, :m.shape[0]] = m
    return out


def shard_filters(global_mask, n_locals) -> torch.Tensor:
    """Split a global-id bitmap into the stacked per-shard local layout:
    shard s's row is global_mask[base_s : base_s + n_local_s]. A mask
    whose length is not the shards' total raises ValueError."""
    gm = _uint8(global_mask)
    total = int(sum(n_locals))
    if gm.shape[0] != total:
        raise ValueError(
            f"global mask covers {gm.shape[0]} ids but shards hold {total} — "
            f"a short mask would silently zero-fill (exclude) trailing shards")
    return stack_filters(torch.split(gm, [int(n) for n in n_locals]))


def local_shards(x, group):
    """This rank's block of a stacked argument under `group`: shards
    [r·D/world, (r+1)·D/world) of a ShardedIVF, ShardedIVFPQ,
    ShardedTreeRouter, filter stack or health mask (numpy or tensor). The
    block is a copy (code blocks kept on 16 bytes), so the full stack can
    be dropped; the placement rule that stands for JAX's PartitionSpecs."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    D = (x[0] if isinstance(x, tuple) else x).shape[0]
    if D % world:
        raise ValueError(f"{D} shards do not split over {world} ranks")
    lo, hi = rank * D // world, (rank + 1) * D // world

    def cut(t):
        return t[lo:hi].clone() if isinstance(t, torch.Tensor) else np.array(t[lo:hi])

    if not isinstance(x, tuple):
        return cut(x)
    return type(x)(*(_aligned_codes(t[lo:hi], t.device) if f == "part_codes"
                     else cut(t) for f, t in zip(x._fields, x)))


def _local_router(C: torch.Tensor, tables, t_route: Optional[int]):
    """A shard's probe router: its tree tables (SC, CH, CC) when given,
    else the flat probe over its centroids. t_route defaults to ceil(S/8)
    of the (padded) super count."""
    if tables is None:
        return FlatRouter(C)
    SC, CH, CC = tables
    S = SC.shape[0]
    return TreeRouter(SC, CH, CC,
                      t_route=max(1, -(-S // 8)) if t_route is None else t_route,
                      n_partitions=C.shape[0])


def _mask_unhealthy(ids, vals, ok):
    """Degraded fan-out (DESIGN.md §3.13): a down shard's (ok false) rows
    become the (-1, -inf) padding before the merge, so the merged top k
    comes from the healthy shards alone. A healthy shard's tensors pass
    through the select unchanged, so an all-ones mask gives the bits of
    the search without health."""
    if ok is None:
        return ids, vals
    return torch.where(ok, ids, -1), torch.where(ok, vals, float("-inf"))


def _apply_params(params, top_t, final_k):
    """Resolve a serve/api.SearchParams against a maker's kwargs → (top_t,
    k). Its escalate is not used: the shard-parallel makers do not
    escalate, as in JAX."""
    if params is None:
        return top_t, final_k
    p = params.validate(default_top_t=top_t)
    return p.top_t, p.k


def _shard_view(ivf, s: int, dev: torch.device, with_pq: bool) -> PackedIVF:
    """Shard s of a stack as a PackedIVF on `dev` (views when it lies
    there already). Without PQ the extent is unused."""
    def t(a):
        return a[s].to(dev)
    return PackedIVF(
        t(ivf.centroids), t(ivf.part_ids), t(ivf.part_codes) if with_pq else None,
        t(ivf.sizes), t(ivf.extent) if with_pq else t(ivf.sizes),
        PQCodebook(t(ivf.pq_centers)) if with_pq else None, t(ivf.rerank))


def _all_gather(ids: torch.Tensor, vals: torch.Tensor, group):
    """Every rank's (D/world, nq, k) results → the (D, nq, k) stacks in
    shard order (rank r holds block r), on the inputs' device."""
    world = dist.get_world_size(group)
    out = []
    for t in (ids, vals):
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t.contiguous(), group=group)
        out.append(torch.cat(parts))
    return out


def _merge(all_ids: torch.Tensor, all_vals: torch.Tensor, k: int):
    """(D, nq, k) per-shard results → the global top k: the shard axis
    moved behind the query axis and flattened to (nq, D·k), then a top k
    with ties to the lowest index (the lower shard)."""
    D, nq, _ = all_ids.shape
    flat_v = all_vals.movedim(0, 1).reshape(nq, D * k)
    flat_i = all_ids.movedim(0, 1).reshape(nq, D * k)
    v, pos = topk_first(flat_v, k)
    return torch.gather(flat_i, 1, pos), v


def _make_search(with_pq: bool, devices, group, *, top_t: int, final_k: int,
                 rerank_budget: int, multiplicity: int, with_filter: bool,
                 with_router: bool, t_route: Optional[int], with_health: bool,
                 q_chunk: Optional[int]):
    """The fn both makers return (arguments in JAX's fixed order: ivf, Q
    [, filt][, router][, health])."""
    n_rest = int(with_filter) + int(with_router) + int(with_health)

    def fn(ivf, Q, *rest):
        if len(rest) != n_rest:
            raise TypeError(f"expected {n_rest} argument(s) after (ivf, Q): "
                            f"with_filter={with_filter}, with_router={with_router}, "
                            f"with_health={with_health}; got {len(rest)}")
        it = iter(rest)
        filt = next(it) if with_filter else None
        srt = next(it) if with_router else None
        health = next(it) if with_health else None
        devs = ([torch.device(d) for d in devices] if devices
                else [ivf.centroids.device])
        Q = as_tensor(Q, devs[0], torch.float32)
        if q_chunk is not None and Q.shape[0] % q_chunk:
            raise ValueError(f"{Q.shape[0]} queries do not split into tiles of "
                             f"q_chunk={q_chunk}")
        if health is not None:
            health = as_tensor(health, devs[0])
        ids, vals = [], []
        for s in range(ivf.local_base.shape[0]):
            dev = devs[s % len(devs)]
            view = _shard_view(ivf, s, dev, with_pq)
            tables = None if srt is None else tuple(t[s].to(dev) for t in srt)
            f = (None if filt is None
                 else as_tensor(filt[s, :view.rerank.shape[0]], dev))
            i, v = search_jit_batched(
                view, Q.to(dev), top_t, final_k, rerank_budget, bq=TILE_ROWS,
                multiplicity=multiplicity, filter=f, escalate=False,
                router=_local_router(view.centroids, tables, t_route),
                tile_rows=TILE_ROWS)
            # globalise, keeping -1: an under-filled shard must not alias
            # into the shard before it
            i = torch.where(i >= 0, i + ivf.local_base[s].to(dev), -1)
            i, v = _mask_unhealthy(i, v, None if health is None
                                   else health[s].to(dev) > 0)
            ids.append(i.to(devs[0]))
            vals.append(v.to(devs[0]))
        all_ids, all_vals = torch.stack(ids), torch.stack(vals)
        if group is not None:
            all_ids, all_vals = _all_gather(all_ids, all_vals, group)
        return _merge(all_ids, all_vals, final_k)

    return fn


def make_distributed_search(devices: Optional[Sequence] = None, *, top_t: int,
                            final_k: int = 10, multiplicity: int = 2,
                            with_filter: bool = False, with_router: bool = False,
                            t_route: Optional[int] = None,
                            with_health: bool = False, params=None, group=None):
    """Returns fn(ShardedIVF, Q (nq, d)) → (ids (nq, final_k) int32 global,
    scores (nq, final_k) f32), each shard's window scored exactly from its
    f32 rerank rows. Placement (`devices`, `group`): the module docstring.

    Pass multiplicity ≥ 1 + n_spills when serving multi-spill shards
    (dedup_topk_window's bound); 2 covers single-spill builds.

    with_filter=True: fn takes a (D, n_local) uint8 local-id bitmap stack
    (stack_filters / shard_filters) and masks candidates before dedup.
    with_router=True: fn takes a ShardedTreeRouter (stack_tree_routers of
    the shards' routers) and probes each shard through its own tables at
    `t_route` (default ceil(S/8)) instead of the flat probe.
    with_health=True: fn takes a final (D,) uint8 health mask
    (HealthTracker.mask) and serves the top k of the healthy shards; an
    all-ones mask gives the bits of the search without health.
    params: an optional serve/api.SearchParams whose k / top_t override
    the kwargs (its escalate is not used here, as in JAX).
    """
    top_t, final_k = _apply_params(params, top_t, final_k)
    return _make_search(False, devices, group, top_t=top_t, final_k=final_k,
                        rerank_budget=256, multiplicity=multiplicity,
                        with_filter=with_filter, with_router=with_router,
                        t_route=t_route, with_health=with_health, q_chunk=None)


def make_distributed_search_pq(devices: Optional[Sequence] = None, *, top_t: int,
                               final_k: int = 10, rerank_k: int = 256,
                               q_chunk: int = 128, multiplicity: int = 2,
                               with_filter: bool = False, with_router: bool = False,
                               t_route: Optional[int] = None,
                               with_health: bool = False, params=None, group=None):
    """The PQ-scored shard-parallel search (the paper's pipeline). Per
    shard and tile: the probe, the PQ LUT score plus the coarse term of the
    probed partitions read by probe id (the probe scorer on the card),
    dedup-by-max to the top rerank_k, exact rerank of those, the local top
    k; then the global merge. Returns fn(ShardedIVFPQ, Q[, filt][, router]
    [, health]) → (ids, scores) as `make_distributed_search`, whose
    with_filter / with_router / t_route / with_health / params it shares.

    q_chunk is JAX's tile: nq must be a multiple of it (ValueError
    otherwise), as in JAX; the tiles themselves run at TILE_ROWS rows.
    """
    top_t, final_k = _apply_params(params, top_t, final_k)
    return _make_search(True, devices, group, top_t=top_t, final_k=final_k,
                        rerank_budget=rerank_k, multiplicity=multiplicity,
                        with_filter=with_filter, with_router=with_router,
                        t_route=t_route, with_health=with_health, q_chunk=q_chunk)


# ------------------------------------------------------------- durability
def save_sharded(path: str, indexes, *, extra=None):
    """Per-shard snapshot envelope (DESIGN.md §3.11): one CRC-checked
    snapshot subdirectory per shard (IVFIndex or MutableIVF, its whole
    mutation state) and an envelope manifest, committed by one atomic
    directory swap. Save the per-shard indexes, not the stack: the
    envelope restores them and `sharded_from_indexes(_pq)` re-stacks them
    bit for bit."""
    from repro_torch.ckpt.index_store import save_shards
    save_shards(path, indexes, extra=extra)


def load_sharded(path: str, device: Device = None):
    """→ (per-shard index objects on `device` (CUDA unless "cpu"), extra).
    Re-stack with `sharded_from_indexes(_pq)`; a torn or bit-flipped shard
    raises CorruptSnapshotError at load."""
    from repro_torch.ckpt.index_store import load_shards
    return load_shards(path, device=device)


# --------------------------------------------------------- replica fan-out
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
                           with_filter: bool = False, escalate: Union[bool, str] = True,
                           params=None, bq: int = 128,
                           tile_rows: Optional[int] = None):
    """Replica fan-out over `devices` (torch devices or their names; one
    device may appear twice). Returns fn(PackedIVF, Q[, filter], *,
    queries=None) → (ids, scores) on the first device; Q's row count must
    be divisible by the number of replicas (serving callers get this from
    `pad_queries(..., multiple=R)`).

    Replica r takes rows [r·L, (r+1)·L) of Q (L = nq / R) and runs
    `search_jit_batched` on its own copy of the index in tiles of `bq`
    queries, each run at `tile_rows` rows when given. With the same `bq`
    and `tile_rows` as the single-device path, every query is searched at
    the same shapes as there, so results are the same bits. `queries`:
    Q's leading rows that are queries (default all), max(0, min(L,
    queries − r·L)) of them replica r's; the rest pad the batch and never
    escalate. escalate: True, False or "budget" (`search_jit_batched`).

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

    def fn(packed: PackedIVF, Q, filt=None, *, queries: Optional[int] = None):
        if with_filter != (filt is not None):
            raise TypeError("pass a filter exactly when with_filter=True")
        Q = as_tensor(Q, packed.centroids.device, torch.float32)
        nq = Q.shape[0]
        if nq % R:
            raise ValueError(f"{nq} query rows do not split over {R} replicas")
        L = nq // R
        real = nq if queries is None else int(queries)
        outs = []
        for r, (dev, copy) in enumerate(zip(devs, replicas(packed))):
            f = None if filt is None else as_tensor(filt, dev)
            outs.append(search_jit_batched(
                copy, Q[r * L:(r + 1) * L].to(dev), top_t=top_t,
                final_k=final_k, rerank_budget=rerank_budget, bq=bq,
                multiplicity=multiplicity, filter=f, escalate=escalate,
                tile_rows=tile_rows, queries=max(0, min(L, real - r * L))))
        out_dev = devs[0]
        return (torch.cat([o[0].to(out_dev) for o in outs]),
                torch.cat([o[1].to(out_dev) for o in outs]))

    return fn
