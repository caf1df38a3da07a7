"""Serving request API (a copy of `repro/serve/api.py`, DESIGN.md §3.12).

The port keeps its own copy of this JAX-free module, so that it imports
nothing of the JAX package. It stays numpy at the edge, as there:

- `SearchParams`: everything a caller can ask of a search (k, probe
  budget, rerank budget, subset filters, escalation and sanitize policy,
  a latency deadline, a tenant handle). Immutable; `validate()` is the one
  place serving defaults and argument checks live, and `batch_key()` the
  coalescing identity a batching front-end derives from it.
- `SearchResult`: ids and scores plus the serving metadata (engine time,
  queue wait, batch size, escalation flag, index epoch served,
  degraded / shards_ok / retries). Unpacks like the legacy `(ids, scores)`.
- The serving **error taxonomy** (DESIGN.md §3.13): `ServingError` and its
  subclasses `OverloadedError`, `DeadlineExceededError` and
  `FrontendClosedError`, carrying `queued_us` / `engine_us`;
  `is_retryable` classifies any exception for a bounded retry.
- `validate_queries`: query hygiene at the edge.

Defaults:

    DEFAULT_K              final neighbors returned
    DEFAULT_TOP_T          partitions probed
    DEFAULT_RERANK_BUDGET  candidates exactly reranked after PQ scoring
    DEFAULT_BQ             serving query tile
    DEFAULT_DEADLINE_MS    batching deadline when a request carries none
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.router import check_query_dim
from repro_torch.core.search import ESCALATE_BUDGET

DEFAULT_K = 10
DEFAULT_TOP_T = 8
DEFAULT_RERANK_BUDGET = 256
DEFAULT_BQ = 128
DEFAULT_DEADLINE_MS = 50.0
# deadline_ms bounds (§3.13): a request whose budget is under the floor
# cannot complete even on an idle engine (one padded jit dispatch costs
# more), so it is unsatisfiable AT SUBMIT and rejected there instead of
# being admitted, queued, and shed at dispatch; above the cap "deadline"
# stops meaning anything — pass deadline_ms=None (best-effort, never
# shed) instead of a number nothing will ever exceed.
MIN_DEADLINE_MS = 0.05
MAX_DEADLINE_MS = 600_000.0
# SearchParams.escalate: no escalation, one escalated second pass, or
# thin rows walked up the router's escalation steps to the stage budget
ESCALATE_MODES = (False, True, ESCALATE_BUDGET)


class ServingError(RuntimeError):
    """Base of the serving error taxonomy (DESIGN.md §3.13).

    Every subclass records whether a client retry can help (`retryable`)
    and carries the same timing metadata a successful SearchResult would
    (`queued_us`/`engine_us`) — a shed or expired request still tells
    the caller how long it sat and how much engine time it consumed
    (always 0 for requests rejected before dispatch), so SLO accounting
    covers failures, not just successes.

    The taxonomy is also the front-end's retry policy: `is_retryable`
    drives its bounded retry + exponential backoff for engine failures
    (DESIGN.md §3.13), and tells clients of OverloadedError to back off
    and resubmit vs. clients of DeadlineExceededError that resubmitting
    the same budget will fail the same way.
    """
    retryable = False

    def __init__(self, msg: str, *, queued_us: float = 0.0,
                 engine_us: float = 0.0):
        super().__init__(msg)
        self.queued_us = float(queued_us)
        self.engine_us = float(engine_us)


class OverloadedError(ServingError):
    """Admission control rejected (or load shedding evicted) the request:
    the front-end's bounded queue is full. Retryable — by the CLIENT,
    after backoff; the front-end itself never retries shed work (that
    would re-add the load being shed)."""
    retryable = True


class DeadlineExceededError(ServingError):
    """The request's deadline expired while it was still queued: it was
    dropped at dispatch time instead of consuming engine capacity on an
    answer nobody is waiting for. Not retryable — the budget is spent;
    resubmitting with the same deadline under the same load fails the
    same way."""
    retryable = False


class FrontendClosedError(ServingError):
    """The front-end is closed — either an orderly `close()` or a fatal
    dispatcher failure (the original failure is `__cause__`). Pending
    Futures are failed with this instead of hanging; `submit` after
    close raises it synchronously."""
    retryable = False


def is_retryable(exc: BaseException) -> bool:
    """Transient-failure classification for the front-end's bounded
    retry (DESIGN.md §3.13). An error is retryable iff it says so: the
    ServingError taxonomy and the fault injectors carry a `retryable`
    attribute, and a few stdlib transport-ish types (TimeoutError,
    ConnectionError, InterruptedError) are transient by nature.
    Everything else — ValueError from bad inputs, engine invariant
    failures, InjectedCrash — is fatal for the request: retrying a
    deterministic failure just triples its latency."""
    r = getattr(exc, "retryable", None)
    if r is not None:
        return bool(r)
    return isinstance(exc, (TimeoutError, ConnectionError,
                            InterruptedError))


def _positive_int(name: str, v) -> int:
    """Serving-edge bounds check: k/top_t/rerank_budget/bq must be
    positive integers — an explicit 0 (or a float, or a bool) is a caller
    bug and gets a clear error instead of silently searching nothing or
    falling back to a default."""
    if isinstance(v, bool) or not isinstance(v, (int, np.integer)) or v < 1:
        raise ValueError(f"{name} must be a positive integer, got {v!r}")
    return int(v)


def validate_queries(Q, d: int, *, sanitize: bool = False) -> np.ndarray:
    """Query hygiene for serving entry points (DESIGN.md §3.11): returns
    a (nq, d) float32 batch or raises a clear ValueError. Rejects
    non-numeric dtypes and wrong rank; non-finite values (NaN/Inf —
    including float64 magnitudes that overflow the float32 cast) raise
    unless `sanitize`, which zeroes them. Without this, one NaN query
    poisons its whole jit tile's scores with no error anywhere."""
    Q = np.asarray(Q)
    if (Q.dtype == object or not np.issubdtype(Q.dtype, np.number)
            or np.issubdtype(Q.dtype, np.complexfloating)):
        raise ValueError(
            f"queries must be real-numeric, got dtype {Q.dtype}")
    Q = np.atleast_2d(Q)
    if Q.ndim != 2:
        raise ValueError(
            f"queries must be (nq, d) or (d,), got shape {tuple(Q.shape)}")
    check_query_dim(Q, d)
    with np.errstate(over="ignore"):   # cast overflow → inf, caught below
        Q = Q.astype(np.float32, copy=False)
    if Q.size and not np.isfinite(Q).all():
        if sanitize:
            Q = np.nan_to_num(Q, nan=0.0, posinf=0.0, neginf=0.0)
        else:
            bad = int((~np.isfinite(Q)).sum())
            raise ValueError(
                f"queries contain {bad} non-finite value(s) (NaN/Inf); "
                f"pass sanitize=True to zero them")
    return Q


@dataclass(frozen=True)
class SearchParams:
    """Everything a serving caller can ask of one search request.

    `top_t`/`rerank_budget` of None resolve to the serving object's
    configured values (AnnEngine's constructor args, KNNMemory's `top_t`
    field) — `validate()` performs that resolution plus the hardened-edge
    bounds checks, and is the ONE validation path shared by every edge.

    Subset filters (`filter_ids`/`filter_mask`, and the kNN-memory-shaped
    `recency`/`segment`) compose with the index's standing tombstone
    filter exactly as the legacy kwargs did. `tenant` names a standing
    per-tenant filter registered with the front-end's TenantFilterBank —
    resolution happens at dispatch, against a device-cached bitmap.

    `escalate` (ESCALATE_MODES) says what a filtered search does for a
    query whose filtered window is thin: False nothing; True one second
    pass one router-escalation step up; "budget" walks it up the steps,
    on the device, until it holds as many unique eligible candidates as
    the stage budget (capped at the filter's population) or the router is
    exhausted (DESIGN.md §3.9).

    `deadline_ms` is the front-end batching budget: the micro-batcher
    flushes a pending batch no later than half the oldest request's
    deadline (DESIGN.md §3.12). Direct engine calls ignore it.
    """
    k: int = DEFAULT_K
    top_t: Optional[int] = None
    rerank_budget: Optional[int] = None
    filter_ids: Optional[Sequence[int]] = None
    filter_mask: Optional[np.ndarray] = None
    recency: Optional[int] = None
    segment: Optional[int] = None
    escalate: Union[bool, str] = True
    sanitize: bool = False
    deadline_ms: Optional[float] = None
    tenant: Optional[str] = None

    # -------------------------------------------------------- validation
    def validate(self, *, default_top_t: Optional[int] = None,
                 default_rerank: Optional[int] = None) -> "SearchParams":
        """Resolve None fields against the serving object's defaults and
        bounds-check everything; returns a fully-resolved copy. This is
        the deduplicated hardened path both AnnEngine and KNNMemory route
        through (an explicit top_t=0 raises here, never silently falls
        back to a default)."""
        k = _positive_int("k", self.k)
        top_t = self.top_t if self.top_t is not None else default_top_t
        if top_t is not None:
            top_t = _positive_int("top_t", top_t)
        rb = (self.rerank_budget if self.rerank_budget is not None
              else default_rerank)
        if rb is not None:
            rb = _positive_int("rerank_budget", rb)
        dl = self.deadline_ms
        if dl is not None:
            if isinstance(dl, bool) or not isinstance(
                    dl, (int, float, np.integer, np.floating)) \
                    or not np.isfinite(dl) or dl <= 0:
                raise ValueError(
                    f"deadline_ms must be a positive finite number, "
                    f"got {dl!r}")
            dl = float(dl)
            # Deadline semantics (DESIGN.md §3.13): the budget runs from
            # submit() admission to Future completion. The front-end
            # flushes a pending batch by half the oldest deadline and
            # SHEDS any still-queued request at dispatch once its budget
            # is spent (DeadlineExceededError). A budget below the floor
            # is unsatisfiable at submit (one engine dispatch already
            # exceeds it) and is rejected HERE — admitting it would just
            # convert a caller bug into queue churn and a guaranteed
            # shed. deadline_ms=None means best-effort: paced by the
            # front-end's default_deadline_ms for batching, never shed.
            if not MIN_DEADLINE_MS <= dl <= MAX_DEADLINE_MS:
                raise ValueError(
                    f"deadline_ms={dl!r} is outside "
                    f"[{MIN_DEADLINE_MS}, {MAX_DEADLINE_MS}] — budgets "
                    f"under the floor are unsatisfiable at submit time; "
                    f"pass deadline_ms=None for best-effort (no-shed) "
                    f"serving instead of an unbounded number")
        if self.recency is not None and (
                isinstance(self.recency, bool)
                or not isinstance(self.recency, (int, np.integer))
                or self.recency < 0):
            raise ValueError(
                f"recency must be a non-negative integer, "
                f"got {self.recency!r}")
        esc = self.escalate
        if isinstance(esc, (bool, np.bool_)):
            esc = bool(esc)
        elif not (isinstance(esc, str) and esc in ESCALATE_MODES):
            raise ValueError(f"escalate must be one of {ESCALATE_MODES}, got {esc!r}")
        return dataclasses.replace(self, k=k, top_t=top_t, rerank_budget=rb,
                                   deadline_ms=dl, escalate=esc)

    # ------------------------------------------------------- batching key
    @property
    def has_inline_filter(self) -> bool:
        """An ad-hoc (non-tenant) subset rides this request: a raw
        bitmap/allowlist or a kNN-memory recency/segment window."""
        return (self.filter_ids is not None or self.filter_mask is not None
                or self.recency is not None or self.segment is not None)

    def batch_key(self) -> Optional[Tuple]:
        """Coalescing identity for the front-end micro-batcher: requests
        sharing a key run in ONE padded jit call (the filter bitmap and
        the static search shape are per-call, so they must agree).
        Returns None for requests carrying an ad-hoc inline filter —
        those dispatch solo rather than comparing bitmaps by value."""
        if self.has_inline_filter:
            return None
        return (self.k, self.top_t, self.rerank_budget, self.escalate,
                self.tenant)


@dataclass
class SearchResult:
    """Structured search response: results plus serving metadata.

    `ids`/`scores` are the legacy (nq, k) arrays (`scores` is None on the
    host-engine KNNMemory path, which never computed them). Metadata:

    - engine_us:  device-complete wall time of the jit call that served
                  this request (shared across a coalesced batch)
    - queued_us:  time spent waiting in the front-end queue (0 direct)
    - batch_size: total queries in the coalesced dispatch (== nq direct)
    - escalated:  the selectivity-escalation second pass was armed
    - epoch:      index mutation epoch served (MutableIVF._alive_epoch) —
                  two results at the same epoch are comparable bitwise
    - tenant:     standing filter the request was served under
    - degraded:   served with reduced coverage (§3.13): one or more
                  fan-out targets were down and the result is top-k over
                  the HEALTHY remainder (or a replica dispatch fell back
                  to the local path). False on every healthy-path result,
                  whose ids/scores stay bitwise-identical to pre-§3.13
                  behavior.
    - shards_ok:  when a shard fan-out served this request, the shard
                  indexes that contributed (all of them ⇒ not degraded);
                  None on single-target paths.
    - retries:    transient engine failures absorbed by the front-end's
                  bounded retry before this result was produced.

    Iterates/unpacks as (ids, scores) so structured callers and legacy
    tuple callers share the engines' return value.
    """
    ids: np.ndarray
    scores: Optional[np.ndarray]
    engine_us: float = 0.0
    queued_us: float = 0.0
    batch_size: int = 0
    escalated: bool = False
    epoch: int = -1
    tenant: Optional[str] = None
    deadline_ms: Optional[float] = None
    degraded: bool = False
    shards_ok: Optional[Tuple[int, ...]] = None
    retries: int = 0

    @property
    def nq(self) -> int:
        return int(self.ids.shape[0])

    @property
    def k(self) -> int:
        return int(self.ids.shape[1])

    @property
    def total_us(self) -> float:
        return self.engine_us + self.queued_us

    def deadline_met(self) -> Optional[bool]:
        if self.deadline_ms is None:
            return None
        return self.total_us <= self.deadline_ms * 1e3

    def __iter__(self):
        yield self.ids
        yield self.scores
