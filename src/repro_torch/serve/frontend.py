"""Serving front-end (PyTorch port of `repro/serve/frontend.py`, DESIGN.md
§3.12–3.13): deadline-aware dynamic batching, standing multi-tenant
filters and replica fan-out in front of AnnEngine.

The engine (serve/engine.py) is a synchronous, single-caller edge: every
`search_request` pays its own tile chain, and concurrent callers would
race on the mutable index, whose `pack()` is a view of its own tensors.
This module adds the serving layer:

- **ServingFrontend** — an async request loop. Callers `submit` a
  (queries, SearchParams) request and get a Future (or `await asearch`);
  one dispatcher thread owns the engine and coalesces compatible pending
  requests into ONE `search_request` call.

- **Deadline-aware flushing** — a batch dispatches when it reaches
  `max_batch` queries OR when the oldest compatible request has spent
  half its `deadline_ms` budget waiting (clamped by `max_delay_ms`;
  `max_delay_ms=None` gives the pure half-deadline policy).

- **Determinism** — a request served inside a coalesced batch equals the
  same request served alone at the same index epoch, bit for bit: every
  stage of the search is query-local, the engine pads a batch to the
  JAX package's power-of-two bucket and runs every tile at its `bq` rows
  (on the card cuBLAS picks a product's algorithm by its shape). Requests
  carrying an ad-hoc inline filter (raw bitmap, allowlist) dispatch solo;
  requests sharing a registered `tenant` coalesce, since their filter is
  the same standing bitmap.

- **TenantFilterBank** — standing per-tenant subset filters. A tenant's
  id set is registered once; at dispatch the front-end serves from an
  epoch-keyed LRU of device bitmaps (tenant ∧ alive), so a request costs a
  dict hit, not an O(n) compose and upload. Mutations bump the index's
  epoch and so invalidate every cached bitmap at once.

- **Mutations as barriers** — `add` / `remove` go through the same queue
  and dispatch only from its head, after every earlier search; no search
  submitted after a mutation is served before it. Epoch-tagged
  SearchResults make the order observable.

- **Replica fan-out** — with more than one device and `policy="replica"`
  (or "auto"), coalesced batches are split row-wise over the devices by
  the engine's replica branch (`AnnEngine.search_request(_devices=)`,
  which runs `core/distributed.make_replicated_search`: index copied to
  each device, queries split), with the same bits as the local path. The
  front-end decides whether and where to fan out; the engine owns how a
  request becomes tiles.

Resilience (DESIGN.md §3.13): admission control in cost units (`reject`
or `shed-oldest`; mutations never shed and never evict searches);
deadline expiry of queued searches at collection
(`DeadlineExceededError`); containment of an engine `Exception` to its
group, with bounded exponential-backoff retries of retryable searches
(mutations never retry); a `BaseException` is fatal: every queued Future
fails with `FrontendClosedError` and `submit` raises it afterwards, so no
caller hangs on a dead dispatcher. Replica dispatch runs behind a circuit
breaker (serve/health.py) and falls back to the local path, flagged
`degraded`.

Durability rides the engine snapshot: `save` stores the front-end config
and every tenant mask as `extra` / `extra_arrays` beside the index, in the
JAX package's format, so a snapshot opens in either package; `open`
restores a front-end serving the same tenants, on CUDA unless the caller
passes device="cpu".
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.ckpt.index_store import load_extra_arrays, read_manifest
from repro_torch.core.mutable import EpochLRU
from repro_torch.serve.api import (DEFAULT_DEADLINE_MS, DeadlineExceededError,
                                   FrontendClosedError, OverloadedError,
                                   SearchParams, SearchResult, _positive_int,
                                   is_retryable, validate_queries)
from repro_torch.serve.engine import AnnEngine
from repro_torch.serve.health import HealthTracker
from repro_torch.utils import Device


def replica_devices(device: torch.device) -> List[torch.device]:
    """The devices a replica fan-out spreads over for an index on
    `device`: every visible CUDA device for a CUDA index, the CPU alone
    for a CPU index."""
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


class UnknownTenantError(KeyError):
    """A request named a tenant never registered with the front-end."""


class TenantFilterBank:
    """Standing per-tenant filters over a mutable index (DESIGN.md §3.12).

    A tenant is a named id-subset (e.g. one customer's vectors in a shared
    index). `register` stores the subset as a host bool mask over point
    ids; `get` returns the device uint8 bitmap (tenant ∧ alive) at the
    index's capacity width, which the search's filter path consumes,
    built by `MutableIVF.filter_bitmap(mask=)` on the index's device and
    served from an EpochLRU keyed on (index alive-epoch, capacity width,
    tenant version):

    - index mutation (add/remove) bumps `_alive_epoch` → every tenant's
      cached bitmap is stale and rebuilds on next use (tombstoned ids
      drop out of the tenant's serving set immediately);
    - `register`/`extend` bump the tenant's own version → only that
      tenant rebuilds;
    - unchanged tenants hit the cache: steady-state per-request filter
      cost is a dict lookup, zero host compose, zero upload.

    `capacity` bounds device memory (one byte a slot a tenant): at most
    that many tenant bitmaps stay resident, LRU-evicted (an evicted
    tenant is rebuilt on next use — correctness is unaffected). The
    EpochLRU is the cache class MutableIVF uses at capacity 1 for its
    standing tombstone filter.
    """

    def __init__(self, index, capacity: int = 32):
        self.index = index
        self._cache = EpochLRU(capacity=_positive_int("capacity", capacity))
        self._masks: dict = {}      # tenant -> host bool mask over ids
        self._versions: dict = {}   # tenant -> int, bumped on (re)register
        self._lock = threading.Lock()

    # ------------------------------------------------------------ registry
    def register(self, tenant: str, ids: Optional[Sequence[int]] = None,
                 mask: Optional[np.ndarray] = None) -> None:
        """(Re)define a tenant's id-set from an allowlist or a bool mask.
        Replaces any previous definition and invalidates its cached
        bitmap."""
        if (ids is None) == (mask is None):
            raise ValueError("register needs exactly one of ids= or mask=")
        if mask is not None:
            m = np.asarray(mask).astype(bool).ravel().copy()
        else:
            ii = np.asarray(ids, np.int64).ravel()
            if ii.size and ii.min() < 0:
                raise ValueError("tenant ids must be non-negative")
            m = np.zeros(int(ii.max()) + 1 if ii.size else 0, bool)
            m[ii] = True
        with self._lock:
            self._masks[tenant] = m
            self._versions[tenant] = self._versions.get(tenant, 0) + 1
            self._cache.drop(tenant)

    def extend(self, tenant: str, ids: Sequence[int]) -> None:
        """Grow a tenant's id-set (e.g. after `add` returned fresh ids for
        that tenant's vectors)."""
        ii = np.asarray(ids, np.int64).ravel()
        with self._lock:
            if tenant not in self._masks:
                raise UnknownTenantError(tenant)
            m = self._masks[tenant]
            need = int(ii.max()) + 1 if ii.size else 0
            if need > m.shape[0]:
                m = np.concatenate([m, np.zeros(need - m.shape[0], bool)])
            m[ii] = True
            self._masks[tenant] = m
            self._versions[tenant] += 1
            self._cache.drop(tenant)

    @property
    def tenants(self):
        with self._lock:
            return sorted(self._masks)

    @property
    def fills(self) -> int:
        """Device bitmap (re)builds so far — the observable for cache
        efficiency tests (steady state: one fill per tenant per index
        epoch)."""
        return self._cache.fills

    def __contains__(self, tenant) -> bool:
        with self._lock:
            return tenant in self._masks

    def __len__(self) -> int:
        with self._lock:
            return len(self._masks)

    # ------------------------------------------------------------- serving
    def get(self, tenant: str) -> torch.Tensor:
        """Device uint8 bitmap (tenant ∧ alive) at capacity width, cached
        per (alive-epoch, capacity, tenant-version)."""
        with self._lock:
            if tenant not in self._masks:
                raise UnknownTenantError(tenant)
            idx, m = self.index, self._masks[tenant]
            epoch = (idx._alive_epoch, idx.alive.shape[0],
                     self._versions[tenant])
            return self._cache.get(tenant, epoch,
                                   lambda: idx.filter_bitmap(mask=m))

    # ---------------------------------------------------------- durability
    def state(self):
        """(meta, arrays) for riding an engine snapshot."""
        with self._lock:
            meta = {"tenants": sorted(self._masks)}
            arrays = {f"tenant.{t}": self._masks[t].astype(np.uint8)
                      for t in self._masks}
            return meta, arrays


@dataclass
class _Request:
    """One queued front-end operation. kind: "search" | "add" | "remove"."""
    kind: str
    future: Future
    Q: Optional[np.ndarray] = None
    params: Optional[SearchParams] = None     # validated at submit
    key: Optional[tuple] = None               # coalescing key (None = solo)
    t_admit: float = 0.0                      # perf_counter at submit
    flush_at: float = field(default=float("inf"))
    payload: Optional[tuple] = None           # mutation args
    deadline_at: Optional[float] = None       # absolute expiry (explicit
    #                                           deadline_ms only; None =
    #                                           best-effort, never shed)
    cost: int = 1                             # admission units (queries)
    retries: int = 0                          # dispatch retries so far

    @property
    def nq(self) -> int:
        return int(self.Q.shape[0]) if self.Q is not None else 0

    @property
    def slack(self) -> float:
        """Deadline slack for shed-oldest ordering (None = infinite —
        best-effort requests are shed last)."""
        return (float("inf") if self.deadline_at is None
                else self.deadline_at - time.perf_counter())


class ServingFrontend:
    """Async serving loop in front of AnnEngine (DESIGN.md §3.12).

    One dispatcher thread owns the engine: searches AND mutations flow
    through its queue, so callers never take a lock around the mutable
    index. Compatible searches (same SearchParams.batch_key) coalesce
    into one engine call; mutations are strict barriers.

    Flush policy: a pending group dispatches when

    - its total queries reach `max_batch` (default: the engine's tile
      `bq` — one full tile), or
    - the oldest request in it has waited `min(max_delay_ms,
      deadline_ms / 2)` — half the request's latency budget, clamped so a
      generous deadline doesn't stall the queue (`max_delay_ms=None`
      removes the clamp → pure half-deadline policy), or
    - the front-end is closing / `flush()` was called.

    `policy` selects execution: "local" always runs the single-device
    engine path; "replica" splits each coalesced batch row-wise over the
    index's devices (`replica_devices`: every visible CUDA device for an
    index on the card) through the engine's replica branch (index copied
    to each — the query-bound regime's scaling axis); "auto" picks replica iff more
    than one device is visible. Both paths give each query the same bits,
    so the policy is purely a throughput decision. The dispatcher loop
    runs under a `torch.no_grad()` of its own (grad mode is per thread).
    """

    def __init__(self, engine: AnnEngine, *,
                 max_batch: Optional[int] = None,
                 max_delay_ms: Optional[float] = 2.0,
                 default_deadline_ms: float = DEFAULT_DEADLINE_MS,
                 policy: str = "auto",
                 tenant_capacity: int = 32,
                 max_queue: Optional[int] = None,
                 overload: str = "reject",
                 mutation_cost: Optional[int] = None,
                 max_retries: int = 2,
                 retry_backoff_ms: float = 1.0,
                 breaker_threshold: int = 3,
                 breaker_reset_s: float = 5.0):
        if policy not in ("local", "replica", "auto"):
            raise ValueError(f"policy must be local|replica|auto, "
                             f"got {policy!r}")
        if overload not in ("reject", "shed-oldest"):
            raise ValueError(f"overload must be reject|shed-oldest, "
                             f"got {overload!r}")
        self.engine = engine
        self.max_batch = _positive_int(
            "max_batch", max_batch if max_batch is not None else engine.bq)
        if max_delay_ms is not None and not max_delay_ms > 0:
            raise ValueError("max_delay_ms must be positive or None")
        self.max_delay_ms = max_delay_ms
        self.default_deadline_ms = float(default_deadline_ms)
        self.policy = policy
        self.max_queue = (None if max_queue is None
                          else _positive_int("max_queue", max_queue))
        self.overload = overload
        self.mutation_cost = _positive_int(
            "mutation_cost",
            mutation_cost if mutation_cost is not None else self.max_batch)
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        self.max_retries = int(max_retries)
        if retry_backoff_ms < 0:
            raise ValueError("retry_backoff_ms must be >= 0")
        self.retry_backoff_ms = float(retry_backoff_ms)
        self.health = HealthTracker(fail_threshold=breaker_threshold,
                                    reset_after_s=breaker_reset_s)
        self.tenants = TenantFilterBank(engine.index,
                                        capacity=tenant_capacity)
        self.stats = {"dispatches": 0, "coalesced": 0, "requests": 0,
                      "mutations": 0, "replica_dispatches": 0,
                      "rejected": 0, "shed": 0, "expired": 0,
                      "retries": 0, "failures": 0, "degraded": 0}
        self._q: deque = deque()
        self._cost = 0                  # admission units currently queued
        self._fatal: Optional[BaseException] = None
        self._cond = threading.Condition()
        self._closed = False
        self._draining = False
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-frontend", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- clients
    def submit(self, Q, params: Optional[SearchParams] = None) -> Future:
        """Enqueue a search; returns a Future[SearchResult]. Validation
        (param bounds + query hygiene) runs HERE, in the caller's thread —
        a malformed request fails fast and never reaches the batcher."""
        p = (params or SearchParams()).validate(
            default_top_t=self.engine.top_t,
            default_rerank=self.engine.rerank_budget)
        Q = validate_queries(Q, self.engine.index.centroids.shape[1],
                             sanitize=p.sanitize)
        if p.tenant is not None and p.tenant not in self.tenants:
            raise UnknownTenantError(p.tenant)
        fut: Future = Future()
        now = time.perf_counter()
        deadline = (p.deadline_ms if p.deadline_ms is not None
                    else self.default_deadline_ms)
        wait_ms = deadline / 2.0
        if self.max_delay_ms is not None:
            wait_ms = min(wait_ms, self.max_delay_ms)
        req = _Request("search", fut, Q=Q, params=p, key=p.batch_key(),
                       t_admit=now, flush_at=now + wait_ms * 1e-3,
                       deadline_at=(now + p.deadline_ms * 1e-3
                                    if p.deadline_ms is not None else None),
                       cost=max(int(Q.shape[0]), 1))
        self._enqueue(req)
        return fut

    def search(self, Q, params: Optional[SearchParams] = None,
               **kw) -> SearchResult:
        """Blocking search through the front-end loop. Legacy kwargs
        (k=, top_t=, tenant=, deadline_ms=, ...) accepted as a
        SearchParams shim."""
        if kw:
            if params is not None:
                raise TypeError("pass params= or kwargs, not both")
            params = SearchParams(**kw)
        return self.submit(Q, params).result()

    async def asearch(self, Q, params: Optional[SearchParams] = None
                      ) -> SearchResult:
        """Awaitable search for asyncio servers."""
        import asyncio
        return await asyncio.wrap_future(self.submit(Q, params))

    def add(self, X, tenant: Optional[str] = None) -> np.ndarray:
        """Mutation barrier: append points through the queue (after every
        earlier search, before every later one). With `tenant`, the fresh
        ids also extend that tenant's standing filter atomically with the
        insert (no window where the points are live but unfindable by
        their tenant)."""
        fut: Future = Future()
        self._enqueue(_Request("add", fut, payload=(X, tenant),
                               t_admit=time.perf_counter(),
                               cost=self.mutation_cost))
        return fut.result()

    def remove(self, ids, hard: bool = True) -> int:
        """Mutation barrier: tombstone points through the queue."""
        fut: Future = Future()
        self._enqueue(_Request("remove", fut, payload=(ids, hard),
                               t_admit=time.perf_counter(),
                               cost=self.mutation_cost))
        return fut.result()

    def register_tenant(self, tenant: str,
                        ids: Optional[Sequence[int]] = None,
                        mask: Optional[np.ndarray] = None) -> None:
        self.tenants.register(tenant, ids=ids, mask=mask)

    def flush(self) -> None:
        """Block until every currently queued request has dispatched
        (pending deadline timers are overridden — the queue drains now)."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()
            self._cond.wait_for(
                lambda: not self._q or self._closed
                or self._fatal is not None)
            self._draining = False

    def close(self, drain: bool = True) -> None:
        """Stop the dispatcher. Idempotent, and deterministic about every
        pending Future: `drain=True` (default) serves the queue first;
        `drain=False` fails queued Futures with FrontendClosedError
        immediately. If the dispatcher already died, pending Futures were
        failed at death — close() just reaps the thread."""
        with self._cond:
            if not self._closed:
                if drain and self._fatal is None:
                    self._draining = True
                    self._cond.notify_all()
                    self._cond.wait_for(
                        lambda: not self._q or self._fatal is not None)
                    self._draining = False
                self._fail_pending_locked(FrontendClosedError(
                    "front-end is closed (closed before dispatch)"))
                self._closed = True
                self._cond.notify_all()
        self._thread.join(timeout=10.0)

    def _fail_pending_locked(self, exc: BaseException) -> None:
        """Lock held: fail every queued Future with `exc` and empty the
        queue — nobody blocks on a Future the dispatcher will never
        serve."""
        for r in self._q:
            if not r.future.done():
                r.future.set_exception(exc)
        self._q.clear()
        self._cost = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ---------------------------------------------------------- dispatcher
    def _enqueue(self, req: _Request) -> None:
        with self._cond:
            if self._closed or self._fatal is not None:
                err = FrontendClosedError("front-end is closed")
                err.__cause__ = self._fatal
                raise err
            if (self.max_queue is not None
                    and self._cost + req.cost > self.max_queue):
                self._admit_locked(req)   # sheds or raises OverloadedError
            self._q.append(req)
            self._cost += req.cost
            self._cond.notify_all()

    def _admit_locked(self, req: _Request) -> None:
        """Lock held, queue over budget: make room for `req` or refuse it.

        Mutations never shed (a write's Future is a promise) and never
        evict queued searches — an over-budget mutation is rejected under
        BOTH policies, so a mutation flood backpressures its producer
        instead of starving the search share of the queue. Under
        "shed-oldest", queued searches are evicted least-deadline-slack
        first (the requests most likely to miss anyway); best-effort
        requests (no explicit deadline → infinite slack) go last."""
        if self.overload == "reject" or req.kind != "search":
            self.stats["rejected"] += 1
            raise OverloadedError(
                f"queue full ({self._cost}/{self.max_queue} units pending)")
        victims = sorted((r for r in self._q if r.kind == "search"),
                         key=lambda r: (r.slack, r.t_admit))
        now = time.perf_counter()
        shed = set()
        for v in victims:
            if self._cost + req.cost <= self.max_queue:
                break
            shed.add(id(v))
            self._cost -= v.cost
            self.stats["shed"] += 1
            if not v.future.done():
                v.future.set_exception(OverloadedError(
                    "shed under overload (least deadline slack)",
                    queued_us=(now - v.t_admit) * 1e6))
        if shed:
            self._q = deque(r for r in self._q if id(r) not in shed)
        if self._cost + req.cost > self.max_queue:
            self.stats["rejected"] += 1
            raise OverloadedError(
                f"queue full ({self._cost}/{self.max_queue} units pending, "
                f"nothing sheddable)")

    @torch.no_grad()
    def _loop(self) -> None:
        try:
            while True:
                with self._cond:
                    group, timeout = self._collect_locked()
                    if group is None:
                        if self._closed and not self._q:
                            return
                        self._cond.wait(timeout=timeout)
                        continue
                    if not self._q:
                        self._cond.notify_all()   # wake flush()/close()
                try:
                    self._dispatch(group)
                except Exception as e:       # contained: group-local
                    self._contain(group, e)
                except BaseException as e:   # fatal: crash the dispatcher
                    for r in group:
                        if not r.future.done():
                            r.future.set_exception(e)
                    raise
                with self._cond:
                    if not self._q:
                        self._cond.notify_all()
        except BaseException as e:  # noqa: BLE001 — recorded as _fatal
            self._dispatcher_died(e)

    def _dispatcher_died(self, exc: BaseException) -> None:
        """The dispatcher thread is exiting on a fatal error. Fail every
        queued Future (nobody should block forever on a dead loop) and
        poison `submit` — pinned by the stranded-Future regression test."""
        with self._cond:
            self._fatal = exc
            err = FrontendClosedError(
                f"dispatcher thread died: {exc!r}")
            err.__cause__ = exc
            self._fail_pending_locked(err)
            self._cond.notify_all()

    def _contain(self, group, exc: Exception) -> None:
        """An engine Exception during dispatch: fail THIS group only; the
        dispatcher keeps serving. Retryable search failures get a bounded
        exponential backoff and re-queue at the head (still before any
        queued mutation — searches at one epoch commute, so head re-entry
        preserves the barrier order). Mutations never retry: the engine
        may have partially applied the write, and replaying it could
        double-apply."""
        r0 = group[0]
        if (r0.kind == "search" and is_retryable(exc)
                and r0.retries < self.max_retries):
            time.sleep(self.retry_backoff_ms * (2 ** r0.retries) * 1e-3)
            with self._cond:
                if self._closed or self._fatal is not None:
                    err = FrontendClosedError(
                        "front-end closed during retry")
                    err.__cause__ = exc
                    for r in group:
                        if not r.future.done():
                            r.future.set_exception(err)
                    return
                for r in group:
                    r.retries += 1
                self.stats["retries"] += 1
                self._q.extendleft(reversed(group))
                self._cost += sum(r.cost for r in group)
                self._cond.notify_all()
            return
        self.stats["failures"] += 1
        for r in group:
            if not r.future.done():
                r.future.set_exception(exc)

    def _collect_locked(self):
        """With the lock held: pick the next dispatch group, or
        (None, timeout) to sleep. Mutations dispatch only from the queue
        head (strict barrier); searches group by coalescing key across the
        pre-mutation prefix (searches at one epoch commute, so grouping
        past a different-keyed search is safe — past a mutation is not).

        Deadline enforcement happens HERE, at collection time: a queued
        search whose explicit deadline already passed is dropped with
        DeadlineExceededError instead of consuming engine time. Requests
        already handed to the engine are never clawed back."""
        self._expire_locked()
        q = self._q
        if not q:
            return None, None
        head = q[0]
        if head.kind != "search":
            q.popleft()
            self._cost -= head.cost
            return [head], None
        pre = []                    # searches before the first mutation
        for r in q:
            if r.kind != "search":
                break
            pre.append(r)
        groups: dict = {}
        for r in pre:
            groups.setdefault(r.key if r.key is not None else id(r),
                              []).append(r)
        now = time.perf_counter()
        target = None
        for g in groups.values():   # a full batch dispatches immediately
            if sum(r.nq for r in g) >= self.max_batch:
                target = g
                break
        if target is None:
            ripe = ([min(pre, key=lambda r: r.flush_at)] if self._draining
                    else [r for r in pre if now >= r.flush_at])
            if not ripe:
                return None, max(min(r.flush_at for r in pre) - now, 1e-4)
            first = min(ripe, key=lambda r: r.flush_at)
            target = groups[first.key if first.key is not None
                            else id(first)]
        chosen, total = [], 0
        for r in target:            # cap the coalesced batch at max_batch:
            if chosen and total + r.nq > self.max_batch:
                break               # never overflow into a LARGER padding
            chosen.append(r)        # bucket than solo serving would use
            total += r.nq
            if total >= self.max_batch:
                break
        taken = set(map(id, chosen))
        self._q = deque(r for r in q if id(r) not in taken)
        self._cost -= sum(r.cost for r in chosen)
        return chosen, None

    def _expire_locked(self) -> None:
        """Lock held: shed queued searches whose explicit deadline has
        already passed (their caller has given up; an answer now is pure
        waste). Best-effort requests (deadline_at=None) never expire."""
        now = time.perf_counter()
        dead = [r for r in self._q
                if r.kind == "search" and r.deadline_at is not None
                and now >= r.deadline_at]
        if not dead:
            return
        gone = set(map(id, dead))
        self._q = deque(r for r in self._q if id(r) not in gone)
        self._cost -= sum(r.cost for r in dead)
        self.stats["expired"] += len(dead)
        for r in dead:
            qd = (now - r.t_admit) * 1e6
            if not r.future.done():
                r.future.set_exception(DeadlineExceededError(
                    f"deadline_ms={r.params.deadline_ms} expired after "
                    f"{qd / 1e3:.1f}ms queued", queued_us=qd))

    def _dispatch(self, group) -> None:
        req = group[0]
        if req.kind == "add":
            X, tenant = req.payload
            ids = self.engine.add(X)
            if tenant is not None:
                if tenant in self.tenants:
                    self.tenants.extend(tenant, ids)
                else:
                    self.tenants.register(tenant, ids=ids)
            self.stats["mutations"] += 1
            req.future.set_result(ids)
            return
        if req.kind == "remove":
            ids, hard = req.payload
            n = self.engine.remove(ids, hard=hard)
            self.stats["mutations"] += 1
            req.future.set_result(n)
            return
        self._dispatch_search(group)

    def _dispatch_search(self, group) -> None:
        p = group[0].params          # key-equal across the group
        Qcat = (np.concatenate([r.Q for r in group])
                if len(group) > 1 else group[0].Q)
        filt_dev = (self.tenants.get(p.tenant)
                    if p.tenant is not None else None)
        t0 = time.perf_counter()
        degraded = False
        want_replica = self._use_replica(p)
        use_replica = want_replica and self.health.allow("replica")
        if want_replica and not use_replica:
            degraded = True     # breaker open: full-coverage local serve,
            #                     but the fan-out capacity is reduced
        r = None
        if use_replica:
            try:
                r = self.engine.search_request(
                    Qcat, p, _filter_dev=filt_dev,
                    _devices=replica_devices(self.engine.index.device))
                self.health.success("replica")
                self.stats["replica_dispatches"] += 1
            except Exception:   # replica target failed: trip + fall back
                self.health.failure("replica")
                degraded = True
        if r is None:           # local path (policy, breaker, or fallback)
            r = self.engine.search_request(Qcat, p, _filter_dev=filt_dev)
        ids, vals, escalated = r.ids, r.scores, r.escalated
        if degraded:
            self.stats["degraded"] += len(group)
        engine_us = (time.perf_counter() - t0) * 1e6
        t_done = time.perf_counter()
        epoch = self.engine.index._alive_epoch
        self.stats["dispatches"] += 1
        self.stats["requests"] += len(group)
        self.stats["coalesced"] += len(group) - 1
        total = int(ids.shape[0])
        off = 0
        for r in group:
            sl = slice(off, off + r.nq)
            off += r.nq
            r.future.set_result(SearchResult(
                ids[sl], vals[sl] if vals is not None else None,
                engine_us=engine_us,
                queued_us=(t_done - r.t_admit) * 1e6 - engine_us,
                batch_size=total, escalated=escalated, epoch=epoch,
                tenant=p.tenant, deadline_ms=r.params.deadline_ms,
                degraded=degraded, retries=r.retries))

    # ------------------------------------------------------ replica fan-out
    def _use_replica(self, p: SearchParams) -> bool:
        if self.policy == "local":
            return False
        if len(replica_devices(self.engine.index.device)) < 2:
            return False
        # inline host filters stay on the engine path (it owns their
        # compose-and-upload); tenant filters are already device-resident
        return not p.has_inline_filter

    # ---------------------------------------------------------- durability
    def save(self, path: str) -> None:
        """Snapshot engine + front-end: the index snapshot carries the
        batching config in its manifest and every tenant mask as an
        `extra.` array (same atomicity/CRC guarantees)."""
        self.flush()
        tmeta, tarrays = self.tenants.state()
        cfg = {"max_batch": self.max_batch,
               "max_delay_ms": self.max_delay_ms,
               "default_deadline_ms": self.default_deadline_ms,
               "policy": self.policy,
               "tenant_capacity": self.tenants._cache.capacity,
               "max_queue": self.max_queue,
               "overload": self.overload,
               "mutation_cost": self.mutation_cost,
               "max_retries": self.max_retries,
               "retry_backoff_ms": self.retry_backoff_ms}
        self.engine.save(path, extra={"frontend": cfg, **tmeta},
                         extra_arrays=tarrays)

    @classmethod
    def open(cls, path: str, *, wal: bool = False, fsync: str = "always",
             device: Device = None, **overrides) -> "ServingFrontend":
        """Reopen a saved front-end on `device` (CUDA unless the caller
        passes "cpu"): engine snapshot (+ WAL replay) plus the saved
        batching config and tenant registry. `overrides` replace saved
        config fields (e.g. policy="local")."""
        eng = AnnEngine.open(path, wal=wal, fsync=fsync, device=device)
        ipath = os.path.join(path, "index")
        extra = read_manifest(ipath)["meta"].get("extra", {})
        cfg = dict(extra.get("frontend", {}))
        cfg.update(overrides)
        fe = cls(eng, **cfg)
        arrays = load_extra_arrays(ipath)
        for t in extra.get("tenants", []):
            m = arrays.get(f"tenant.{t}")
            if m is not None:
                fe.tenants.register(t, mask=m.astype(bool))
        return fe
