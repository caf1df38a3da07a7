"""Mutable packed SOAR index: online insert and delete over a frozen
codebook (PyTorch port of `repro/core/mutable.py`, DESIGN.md §3.7).

The VQ and PQ codebooks are FROZEN at build time, which makes mutations
local:

- **insert**: the new vectors' primary + SOAR spill assignments are one
  `assign_fused` call against the fixed centroids (the vq and soar CUDA
  kernels on the card), a stable grouping by partition, and the PQ encode
  of their residuals — O(batch · c), nothing global moves;
- **delete**: a tombstone — the point's partition slots are set to -1, the
  padding sentinel the search already masks, so nothing moves;
- **compaction**: once more than `compact_threshold` of the occupied slots
  are dead, one pass per partition row (a stable sort of its hole mask)
  shifts the live slots left and shrinks `sizes`.

The state lives as tensors on the index's device (`part_ids`,
`part_codes`, `sizes`, `rerank`, `assignments`, `alive`), and `add`,
`remove` and `compact` write them in place there. Partition rows are
padded to a capacity that grows geometrically, so appends are amortized
O(batch). Point ids are stable across every mutation; id space is
append-only.

The rerank rows are the built index's: f32 rows, or, for an index built
with `rerank="int8"`, (n, d) int8 codes and (n,) f32 scales, held so
(no f32 copy; `add` quantizes what it inserts, `int8_quantize`).

Search serves from snapshots: `pack()` → `PackedIVF` for the fixed-budget
engine, whose ids, codes and rerank rows are the index's own tensors
(a view: the next mutation changes it), and `to_ivf_index()` → the CSR
`IVFIndex` of the host engine. Mutations record the partitions they
touched, and the next `pack()` recomputes `sizes`, `extent` and the
router for those rows only; capacity growth or compaction allocate anew
and force a full repack. The equivalence contract — a mutated index
equals a from-scratch build of its live state against the same frozen
stages — is tests/test_torch_serve.py's, as tests/test_mutable.py pins it
for the JAX package.

Durability (DESIGN.md §3.11): with a `MutationWAL` attached
(`attach_wal`), every mutation appends one record, the JAX package's
record byte for byte, BEFORE it applies, and `replay_record` applies a
logged record through the same calls (`add`, `remove`,
`harden_soft_deletes`, `_compact_impl`), so a snapshot plus its log
reopens to the live state bit for bit. Logging copies the batch to the
host; with no log attached nothing is copied.
"""
from __future__ import annotations

import math
import os
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional, Union

import torch

from repro_torch.ckpt.wal import (REC_ADD, REC_COMPACT, REC_HARDEN, REC_REMOVE,
                                  read_records)
from repro_torch.core.build import build_ivf_sharded, spill_plan
from repro_torch.core.ivf import IVFIndex
from repro_torch.core.search import PackedIVF, slot_extent
from repro_torch.kernels.soar_assign import assign_fused
from repro_torch.quant.int8 import Int8Data, int8_quantize, rerank_f32, rerank_table
from repro_torch.quant.pq import PQCodebook, pq_encode
from repro_torch.utils import as_tensor

CAPACITY_SLACK = 1.25    # partition-row capacity over the largest row at wrap time


def _grow_rows(arr, n_new: int, fill):
    """Geometric row growth to at least n_new rows (a new tensor when it
    grows, `arr` itself otherwise); an Int8Data grows its codes and scales
    alike."""
    if isinstance(arr, Int8Data):
        return Int8Data(_grow_rows(arr.q, n_new, 0), _grow_rows(arr.scale, n_new, 0.0))
    if arr.shape[0] >= n_new:
        return arr
    cap = max(n_new, 2 * arr.shape[0], 64)
    out = torch.full((cap,) + tuple(arr.shape[1:]), fill, dtype=arr.dtype,
                     device=arr.device)
    out[:arr.shape[0]] = arr
    return out


class EpochLRU:
    """Epoch-keyed LRU of derived values (device filter bitmaps).

    An entry is (epoch, value) under a caller key; `get` returns the cached
    value while the epoch matches, else rebuilds it through the callback.
    The index keeps a capacity-1 instance for its standing tombstone
    bitmap; a serving front-end holds a capacity-N one keyed by tenant."""

    def __init__(self, capacity: int = 1):
        self.capacity = max(1, int(capacity))
        self._d = OrderedDict()
        self.fills = 0              # cache-miss rebuilds (tests/telemetry)

    def get(self, key, epoch, build):
        hit = self._d.get(key)
        if hit is not None and hit[0] == epoch:
            self._d.move_to_end(key)
            return hit[1]
        val = build()
        self.fills += 1
        self._d[key] = (epoch, val)
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
        return val

    def drop(self, key):
        self._d.pop(key, None)

    def __contains__(self, key):
        return key in self._d

    def __len__(self):
        return len(self._d)


@dataclass
class MutableIVF:
    """Mutable padded-partition SOAR index over frozen VQ/PQ codebooks.
    Every tensor lies on the index's device (the centroids')."""
    centroids: torch.Tensor             # (c, d) f32, FROZEN
    pq: Optional[PQCodebook]            # FROZEN (None → no PQ stage)
    spill_mode: str
    lam: float
    n_spills: int                       # spills per point (0 for "none")
    part_ids: torch.Tensor              # (c, cap) int32; -1 = empty/tombstone
    part_codes: Optional[torch.Tensor]  # (c, cap, m) uint8
    sizes: torch.Tensor                 # (c,) int32 fill offset (dead slots incl.)
    rerank: Union[torch.Tensor, Int8Data]  # (cap_n, d) f32 by point id, or int8
                                           # codes (cap_n, d) + scales (cap_n,)
    assignments: torch.Tensor           # (cap_n, a) int32; -1 rows dead/unused
    alive: torch.Tensor                 # (cap_n,) bool
    n_total: int                        # high-water point id (append-only)
    n_dead_slots: int = 0
    n_soft_deleted: int = 0             # alive False, slots NOT blanked
    compact_threshold: float = 0.25
    # probe router (core/router.py), FROZEN like the codebooks; snapshots
    # serve a view with emptied partitions pruned (_serving_router)
    router: Optional[object] = None
    _packed: Optional[PackedIVF] = field(default=None, repr=False)
    _csr: Optional[IVFIndex] = field(default=None, repr=False)
    # delta-pack state: partitions touched since `_packed` was synced;
    # None marks "needs a full repack"
    _dirty_parts: Optional[torch.Tensor] = field(default=None, repr=False)
    # standing-filter cache: the device uint8 alive bitmap, keyed by an
    # epoch bumped whenever `alive` changes (add/remove)
    _alive_epoch: int = field(default=0, repr=False)
    _filter_cache: EpochLRU = field(default_factory=EpochLRU, repr=False)
    # serving-router cache, keyed by the live-partition mask
    _router_dev: Optional[object] = field(default=None, repr=False)
    _router_key: Optional[torch.Tensor] = field(default=None, repr=False)
    # durability: the sequence number of the last mutation this state
    # covers (a snapshot stores it; replay skips records at or below it),
    # and the attached log, which gets each mutation's record first
    wal_seq: int = 0
    _wal: Optional[object] = field(default=None, repr=False)
    _replaying: bool = field(default=False, repr=False)

    # ------------------------------------------------------- constructors
    @classmethod
    def from_index(cls, idx: IVFIndex, compact_threshold: float = 0.25) -> "MutableIVF":
        """Wrap a built IVFIndex (any build function) into the mutable layout, on
        the index's device. The rerank rows are the index's own (f32 rows,
        or int8 codes and scales) until the first `add` grows them."""
        c = idx.n_partitions
        dev = idx.centroids.device
        sizes = idx.partition_sizes().to(torch.int32)
        smax = int(sizes.max()) if sizes.numel() else 0
        cap = max(8, int(math.ceil(smax * CAPACITY_SLACK)) if sizes.numel() else 8)
        part_ids = torch.full((c, cap), -1, dtype=torch.int32, device=dev)
        m = idx.codes.shape[1] if idx.codes is not None else 0
        part_codes = (torch.zeros((c, cap, m), dtype=torch.uint8, device=dev)
                      if m else None)
        part = torch.repeat_interleave(torch.arange(c, device=dev), sizes)
        pos = (torch.arange(idx.n_assignments, device=dev)
               - torch.repeat_interleave(idx.starts[:-1], sizes))
        part_ids[part, pos] = idx.point_ids
        if m:
            part_codes[part, pos] = idx.codes
        if idx.rerank_f32 is not None:
            data = idx.rerank_f32.to(torch.float32).contiguous()
        else:
            data = Int8Data(idx.rerank_int8.q.contiguous(),
                            idx.rerank_int8.scale.to(torch.float32).contiguous())
        a = idx.assignments.shape[1]
        _, n_spills = spill_plan(idx.spill_mode, idx.lam, a - 1)
        return cls(
            centroids=idx.centroids.to(torch.float32), pq=idx.pq,
            spill_mode=idx.spill_mode, lam=idx.lam, n_spills=n_spills,
            part_ids=part_ids, part_codes=part_codes, sizes=sizes,
            rerank=data,
            assignments=idx.assignments.to(torch.int32).clone(),
            alive=torch.ones(idx.n_points, dtype=torch.bool, device=dev),
            n_total=idx.n_points, compact_threshold=compact_threshold,
            router=idx.router)

    @classmethod
    def build(cls, gen: Optional[torch.Generator], X, n_partitions: int,
              **kw) -> "MutableIVF":
        """Sharded build (core/build.py) → mutable wrap. `device=` and the
        other keywords go to `build_ivf_sharded`."""
        compact_threshold = kw.pop("compact_threshold", 0.25)
        idx = build_ivf_sharded(gen, X, n_partitions, **kw)
        return cls.from_index(idx, compact_threshold=compact_threshold)

    # ------------------------------------------------------------ accessors
    @property
    def device(self) -> torch.device:
        return self.centroids.device

    @property
    def n_alive(self) -> int:
        return int(self.alive[:self.n_total].sum())

    @property
    def n_slots(self) -> int:
        return int(self.sizes.sum())

    @property
    def dead_fraction(self) -> float:
        s = self.n_slots
        return self.n_dead_slots / s if s else 0.0

    @property
    def dedup_multiplicity(self) -> int:
        """The search dedup's `multiplicity`: the window slots one point
        may hold (its primary and spills, at least two)."""
        return 1 + max(self.n_spills, 1)

    def _invalidate(self):
        """Full snapshot invalidation (capacity growth / compaction)."""
        self._packed = None
        self._csr = None
        self._dirty_parts = None

    def invalidate_snapshots(self):
        """Public full invalidation: the next `pack()` / `to_ivf_index()`
        rebuilds from scratch, the pruned router included, instead of
        delta-updating (to hold the delta path against a full repack)."""
        self._invalidate()
        self._router_dev = self._router_key = None

    def _mark_dirty(self, parts: torch.Tensor):
        """Record a local mutation of the rows `parts`: the CSR snapshot is
        rebuilt wholesale, the packed one updates those rows on the next
        pack()."""
        self._csr = None
        if self._packed is None or self._dirty_parts is None:
            self._packed = None
            self._dirty_parts = None
            return
        self._dirty_parts[parts] = True

    # ---------------------------------------------------------- durability
    def attach_wal(self, wal, replay: bool = True) -> int:
        """Attach a MutationWAL (ckpt/wal.py): every later mutation appends
        one record before it applies. With `replay` (default), the log's
        committed records with seq > `wal_seq` are applied first — the
        open-after-crash path (snapshot + log → the live state). Returns
        how many records were replayed."""
        n = 0
        if replay and os.path.exists(wal.path):
            for seq, rtype, meta, arrays in read_records(wal.path):
                n += self.replay_record(seq, rtype, meta, arrays)
        self._wal = wal
        return n

    def replay_record(self, seq: int, rtype: int, meta: dict,
                      arrays: dict) -> bool:
        """Apply one log record if it postdates this state (seq >
        wal_seq), through the same calls that logged it: their
        determinism (frozen-codebook assignment, stable sorts) makes
        recovery bit for bit."""
        from repro_torch.ckpt.index_store import CorruptSnapshotError
        if seq <= self.wal_seq:
            return False               # already folded into the snapshot
        self._replaying = True
        try:
            if rtype == REC_ADD:
                self.add(arrays["x"])
            elif rtype == REC_REMOVE:
                self.remove(arrays["ids"], hard=bool(meta["hard"]))
            elif rtype == REC_HARDEN:
                self.harden_soft_deletes()
            elif rtype == REC_COMPACT:
                self._compact_impl()
            else:
                raise CorruptSnapshotError(
                    f"unknown WAL record type {rtype} (seq {seq})")
        finally:
            self._replaying = False
        self.wal_seq = seq
        return True

    def _log(self, rtype: int, meta: Optional[dict] = None,
             arrays: Optional[dict] = None):
        """Write-ahead: append the record (durably, per the log's fsync
        policy) BEFORE the mutation applies; tensors are copied to the
        host only here, when a log is attached. A crash after the append
        recovers to the post-mutation state by replay; a crash during it
        leaves a torn record that recovery drops."""
        if self._wal is None or self._replaying:
            return
        host = {k: v.cpu().numpy() for k, v in (arrays or {}).items()}
        self.wal_seq = self._wal.append(rtype, meta, host)

    # ------------------------------------------------------------ mutation
    def add(self, X_new) -> torch.Tensor:
        """Insert a batch of vectors (numpy array or tensor); returns their
        stable point ids, an int32 tensor on the index's device.

        Assignments run against the frozen codebook through `assign_fused`;
        the (batch · a) entries are grouped by partition with a stable sort
        (the order of the JAX package's counting sort) and appended at each
        partition's fill offset; PQ codes encode the residual to each
        assignment's centroid, as at build time. Int8 rerank rows store the
        batch's `int8_quantize`.
        """
        dev = self.device
        X_new = as_tensor(X_new, dev, torch.float32)
        if X_new.dim() == 1:
            X_new = X_new[None, :]
        b = X_new.shape[0]
        if b == 0:
            return torch.empty(0, dtype=torch.int32, device=dev)
        X_new = X_new.contiguous()
        self._log(REC_ADD, arrays={"x": X_new})
        eff_lam, eff_spills = spill_plan(self.spill_mode, self.lam, self.n_spills)
        A = assign_fused(X_new, self.centroids, lam=eff_lam, n_spills=eff_spills)
        a = A.shape[1]
        ids = torch.arange(self.n_total, self.n_total + b, dtype=torch.int32,
                           device=dev)
        cap_parts0 = self.part_ids.shape[1]
        cap_rerank0 = rerank_table(self.rerank).shape[0]

        # per-point state (geometric growth keeps appends amortized O(b))
        need = self.n_total + b
        self.rerank = _grow_rows(self.rerank, need, 0.0)
        self.assignments = _grow_rows(self.assignments, need, -1)
        self.alive = _grow_rows(self.alive, need, False)
        if isinstance(self.rerank, Int8Data):
            q8 = int8_quantize(X_new)
            self.rerank.q[self.n_total:need] = q8.q
            self.rerank.scale[self.n_total:need] = q8.scale
        else:
            self.rerank[self.n_total:need] = X_new
        self.assignments[self.n_total:need] = A
        self.alive[self.n_total:need] = True
        self._alive_epoch += 1

        # partition inserts: the (b·a) flat entries grouped by partition,
        # each group appended at its partition's fill offset
        c = self.centroids.shape[0]
        flat_part = A.reshape(-1).to(torch.int64)
        order = torch.sort(flat_part, stable=True).indices
        sp = flat_part[order]
        counts = torch.bincount(sp, minlength=c)
        new_sizes = self.sizes + counts.to(torch.int32)
        cap = self.part_ids.shape[1]
        top = int(new_sizes.max())
        if top > cap:
            new_cap = max(top, 2 * cap)
            grown = torch.full((c, new_cap), -1, dtype=torch.int32, device=dev)
            grown[:, :cap] = self.part_ids
            self.part_ids = grown
            if self.part_codes is not None:
                gc = torch.zeros((c, new_cap, self.part_codes.shape[2]),
                                 dtype=torch.uint8, device=dev)
                gc[:, :cap] = self.part_codes
                self.part_codes = gc
        rank = torch.arange(sp.shape[0], device=dev) - (torch.cumsum(counts, 0) - counts)[sp]
        pos = self.sizes[sp].to(torch.int64) + rank
        self.part_ids[sp, pos] = torch.repeat_interleave(ids, a)[order]
        if self.pq is not None and self.part_codes is not None:
            res = torch.repeat_interleave(X_new, a, dim=0) - self.centroids[flat_part]
            self.part_codes[sp, pos] = pq_encode(self.pq, res)[order]
        self.sizes = new_sizes
        self.n_total = need
        if (self.part_ids.shape[1] != cap_parts0
                or rerank_table(self.rerank).shape[0] != cap_rerank0):
            self._invalidate()       # capacity grew → the snapshot's tensors are old
        else:
            self._mark_dirty(torch.unique(sp))
        return ids

    def remove(self, ids, hard: bool = True) -> int:
        """Tombstone a batch of point ids (numpy array, list or tensor);
        returns how many were removed.

        hard=True (default): their slots are set to -1, nothing moves;
        compaction runs once the dead-slot fraction crosses
        `compact_threshold`.

        hard=False: the point is only marked dead in `alive` — no slot
        changes and no snapshot is invalidated. Soft tombstones are served
        through the standing filter bitmap, and `harden_soft_deletes()`
        turns them into hard ones in one batch.
        """
        ids = torch.unique(as_tensor(ids, self.device, torch.int64).reshape(-1))
        ids = ids[(ids >= 0) & (ids < self.n_total)]
        ids = ids[self.alive[ids]]
        if ids.numel() == 0:
            return 0
        self._log(REC_REMOVE, {"hard": bool(hard)}, {"ids": ids})
        self._alive_epoch += 1
        self.alive[ids] = False
        if not hard:
            self.n_soft_deleted += int(ids.numel())
            return int(ids.numel())
        self._blank_slots(ids)
        return int(ids.numel())

    def _blank_slots(self, ids: torch.Tensor):
        """Hard-tombstone bookkeeping shared by remove(hard=True) and
        harden_soft_deletes: set the ids' slots to -1 in the rows their
        assignments name, retire their assignment rows, mark those rows
        dirty, maybe compact."""
        rows = torch.unique(self.assignments[ids].reshape(-1))
        rows = rows[rows >= 0].to(torch.int64)
        sub = self.part_ids[rows]
        dead = torch.isin(sub, ids.to(torch.int32))
        self.part_ids[rows] = torch.where(dead, -1, sub)
        self.n_dead_slots += int(dead.sum())
        self.assignments[ids] = -1
        self._mark_dirty(rows)
        if self.dead_fraction > self.compact_threshold:
            # implied by the remove / harden record already logged: a
            # record of its own would compact twice on replay
            self._compact_impl()

    def compact(self):
        """Shift live slots left within each partition, dropping tombstones.

        A stable sort of each row's hole mask: survivors keep their slot
        order (hence the search's tie order); point ids do not change.
        """
        self._log(REC_COMPACT)
        self._compact_impl()

    def _compact_impl(self):
        hole = (self.part_ids < 0).to(torch.uint8)
        order = torch.sort(hole, dim=1, stable=True).indices   # live slots first
        self.part_ids = torch.gather(self.part_ids, 1, order)
        if self.part_codes is not None:
            self.part_codes = torch.gather(
                self.part_codes, 1,
                order[:, :, None].expand(-1, -1, self.part_codes.shape[2]))
        self.sizes = (self.part_ids >= 0).sum(1).to(torch.int32)
        self.n_dead_slots = 0
        self._invalidate()

    def harden_soft_deletes(self) -> int:
        """Turn soft tombstones (alive False, slots intact) into hard ones
        (slots -1) in one batch; returns how many. May compact."""
        self._log(REC_HARDEN)
        dead = torch.nonzero(~self.alive[:self.n_total]
                             & (self.assignments[:self.n_total, 0] >= 0)).reshape(-1)
        self.n_soft_deleted = 0
        if dead.numel() == 0:
            return 0
        self._blank_slots(dead)
        return int(dead.numel())

    # ------------------------------------------------------------ filtering
    @property
    def standing_filter_thin(self) -> bool:
        """True when most ids are soft-deleted, so probe escalation through
        the standing filter can plausibly help."""
        return 2 * self.n_soft_deleted > self.n_total

    def serving_filter(self, mask=None, ids=None, escalate: Union[bool, str] = True):
        """(device filter or None, escalate: True, False or "budget") for
        the serving path:

        - no user subset → the cached standing bitmap (only while soft
          tombstones exist), escalation gated on `standing_filter_thin`;
        - a user subset → a freshly composed `filter_bitmap`, escalation as
          the caller asks."""
        if mask is None and ids is None:
            if not self.n_soft_deleted:
                return None, escalate
            return (self.standing_filter(),
                    escalate if self.standing_filter_thin else False)
        return self.filter_bitmap(mask=mask, ids=ids), escalate

    def standing_filter(self) -> torch.Tensor:
        """The cached device uint8 alive bitmap at capacity width, rebuilt
        only when `alive` has changed since the last call."""
        return self._filter_cache.get(
            None, (self._alive_epoch, self.alive.shape[0]),
            lambda: self.alive.to(torch.uint8))

    def filter_bitmap(self, mask=None, ids=None) -> torch.Tensor:
        """The alive bitmap AND an optional user subset, given as a bitmap
        over point ids and/or an id allowlist (numpy or tensor). uint8 on
        the device at the rerank CAPACITY width (the width `alive` and
        `rerank` share); rows past n_total are 0. A short mask zero-pads,
        a long one is cut."""
        out = self.alive.to(torch.uint8)
        width = out.shape[0]
        if ids is not None:
            sel = torch.zeros_like(out)
            ii = as_tensor(ids, self.device, torch.int64).reshape(-1)
            sel[ii[(ii >= 0) & (ii < width)]] = 1
            out &= sel
        if mask is not None:
            m = torch.zeros_like(out)
            mm = as_tensor(mask, self.device).reshape(-1)[:width].to(torch.bool)
            m[:mm.shape[0]] = mm.to(torch.uint8)
            out &= m
        return out

    # ------------------------------------------------------------ snapshots
    def _serving_router(self):
        """The router snapshots serve: the frozen tables, with a TreeRouter
        pruned against the current live-partition mask (children of
        partitions with no live slot become -1). Cached by the mask, so an
        `add` that repopulates an emptied partition un-prunes it on the
        next snapshot."""
        if self.router is None:
            return None
        live = (self.part_ids >= 0).any(dim=1)
        if (self._router_dev is None or self._router_key is None
                or not torch.equal(self._router_key, live)):
            rt = self.router
            if hasattr(rt, "pruned"):
                rt = rt.pruned(live)
            self._router_dev = rt
            self._router_key = live
        return self._router_dev

    def _apply_pack_delta(self, p: PackedIVF) -> PackedIVF:
        """Bring the cached snapshot in step: `sizes` (live count) and
        `extent` of the dirty rows, and the router. Ids, codes and rerank
        rows are the index's own tensors, already current."""
        dirty = torch.nonzero(self._dirty_parts).reshape(-1)
        if dirty.numel():
            rows = self.part_ids[dirty]
            p.sizes[dirty] = (rows >= 0).sum(1).to(torch.int32)
            p.extent[dirty] = slot_extent(rows)
        self._dirty_parts.zero_()
        return p._replace(router=self._serving_router())

    def pack(self) -> PackedIVF:
        """Padded snapshot for the fixed-budget engine (cached).

        Built at the CAPACITY width of the partition rows: `part_ids`,
        `part_codes` and `rerank` are the index's own tensors (no copy),
        so the snapshot is a view that the next mutation changes; `sizes`
        (live ids) and `extent` (last live slot + 1) are the snapshot's
        own and are recomputed for the rows a mutation touched, on the
        next pack(). `_dirty_parts` alone keeps `sizes`, `extent` and the
        router in step: every mutation that changes a slot marks its rows
        (or forces a full repack), and a soft removal changes no slot.
        Extra padded slots hold -1, which the search masks: results equal
        a tight pack's."""
        if self._packed is not None and self._dirty_parts is not None:
            if bool(self._dirty_parts.any()):
                self._packed = self._apply_pack_delta(self._packed)
            return self._packed
        ids = self.part_ids
        self._packed = PackedIVF(
            self.centroids, ids, self.part_codes,
            (ids >= 0).sum(1).to(torch.int32), slot_extent(ids), self.pq,
            self.rerank, self._serving_router())
        self._dirty_parts = torch.zeros(ids.shape[0], dtype=torch.bool,
                                        device=self.device)
        return self._packed

    def to_ivf_index(self) -> IVFIndex:
        """CSR snapshot of the live assignments (host engine; cached).

        Point ids keep their stable values; dead rerank rows stay in the
        table (no partition slot names them).
        """
        if self._csr is not None:
            return self._csr
        n = self.n_total
        r = self.rerank
        r8 = Int8Data(r.q[:n], r.scale[:n]) if isinstance(r, Int8Data) else None
        c = self.part_ids.shape[0]
        mask = self.part_ids >= 0
        starts = torch.zeros(c + 1, dtype=torch.int64, device=self.device)
        starts[1:] = torch.cumsum(mask.sum(1), 0)
        self._csr = IVFIndex(
            centroids=self.centroids, starts=starts,
            point_ids=self.part_ids[mask],
            codes=self.part_codes[mask] if self.part_codes is not None else None,
            pq=self.pq, rerank_int8=r8,
            rerank_f32=None if r8 is not None else r[:n],
            assignments=self.assignments[:self.n_total],
            n_points=self.n_total, spill_mode=self.spill_mode, lam=self.lam,
            router=self._serving_router())
        return self._csr

    def rebuild_reference(self, gen: Optional[torch.Generator] = None) -> IVFIndex:
        """From-scratch build of the CURRENT live rows (ids renumbered
        0.. in id order) against the same frozen codebook, PQ and router:
        the mutation-equivalence comparator. Int8 rows are dequantized and
        the rebuild keeps f32 rows, as the JAX package's f32 table does."""
        live = torch.nonzero(self.alive[:self.n_total]).reshape(-1)
        return build_ivf_sharded(
            gen, rerank_f32(self.rerank)[live], self.centroids.shape[0],
            spill_mode=self.spill_mode, lam=self.lam,
            n_spills=max(self.n_spills, 1), codebook=self.centroids,
            pq=self.pq, router=self.router, device=self.device)
