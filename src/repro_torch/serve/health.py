"""Fan-out target health: per-target circuit breakers (a copy of
`repro/serve/health.py`, DESIGN.md §3.13).

A serving tier that fans requests out — to replicas (the data-parallel
axis, serve/frontend.py) or to database shards (the shard-parallel axis of
the JAX package's core/distributed.py, not ported yet) — must neither keep
sending to a dead target (every request eats a timeout) nor drop a target
forever on one blip (capacity never comes back). The classic answer is a
**circuit breaker** per target:

    CLOSED ──(fail_threshold consecutive failures)──▶ OPEN
    OPEN   ──(reset_after_s elapsed)──▶ HALF_OPEN (admit ONE probe)
    HALF_OPEN ──success──▶ CLOSED          ──failure──▶ OPEN (re-arm)

`CircuitBreaker` is the single-target state machine; `HealthTracker`
holds one per named target and renders the healthy set as the `(D,)`
uint8 mask a degraded shard-parallel search consumes, and as the
allow/deny gate the front-end's replica fan-out consults before
dispatching.

The port keeps its own copy of this JAX-free module, so that it imports
nothing of the JAX package. The clock is injectable (`clock=`), so tests
walk the state machine with a fake clock instead of sleeping. The
front-end records outcomes from its dispatcher thread while stats readers
poll from others; all state flips happen under a lock.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"


class CircuitBreaker:
    """Per-target circuit breaker (state machine above).

    `allow()` is the dispatch gate: True in CLOSED, False in OPEN until
    `reset_after_s` has elapsed since the trip, and True exactly ONCE
    per reset window in HALF_OPEN (the probe request — concurrent
    callers during a probe are denied, so a struggling target sees one
    request, not a thundering herd). Callers report the outcome of every
    allowed dispatch via `record_success` / `record_failure`.
    """

    def __init__(self, *, fail_threshold: int = 3,
                 reset_after_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        if fail_threshold < 1:
            raise ValueError("fail_threshold must be >= 1")
        if reset_after_s <= 0:
            raise ValueError("reset_after_s must be positive")
        self.fail_threshold = int(fail_threshold)
        self.reset_after_s = float(reset_after_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_out = False

    @property
    def state(self) -> str:
        with self._lock:
            return self._peek_state()

    def _peek_state(self) -> str:
        """Lock held: OPEN decays to HALF_OPEN once the window elapses."""
        if (self._state == OPEN
                and self._clock() - self._opened_at >= self.reset_after_s):
            self._state = HALF_OPEN
            self._probe_out = False
        return self._state

    def allow(self) -> bool:
        with self._lock:
            s = self._peek_state()
            if s == CLOSED:
                return True
            if s == HALF_OPEN and not self._probe_out:
                self._probe_out = True     # exactly one probe per window
                return True
            return False

    def record_success(self):
        with self._lock:
            self._state = CLOSED
            self._consecutive_failures = 0
            self._probe_out = False

    def record_failure(self):
        with self._lock:
            s = self._peek_state()
            if s == HALF_OPEN:
                self._trip()               # failed probe re-arms the window
                return
            self._consecutive_failures += 1
            if self._consecutive_failures >= self.fail_threshold:
                self._trip()

    def _trip(self):
        self._state = OPEN
        self._opened_at = self._clock()
        self._consecutive_failures = 0
        self._probe_out = False


class HealthTracker:
    """Named-target health registry: one lazily-created CircuitBreaker
    per target (shard index, "replica", ...), plus the mask/shards_ok
    renderings the degraded fan-out paths consume."""

    def __init__(self, *, fail_threshold: int = 3,
                 reset_after_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        self.fail_threshold = fail_threshold
        self.reset_after_s = reset_after_s
        self._clock = clock
        self._lock = threading.Lock()
        self._breakers: Dict = {}

    def _breaker(self, target) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get(target)
            if b is None:
                b = self._breakers[target] = CircuitBreaker(
                    fail_threshold=self.fail_threshold,
                    reset_after_s=self.reset_after_s, clock=self._clock)
            return b

    def allow(self, target) -> bool:
        return self._breaker(target).allow()

    def success(self, target):
        self._breaker(target).record_success()

    def failure(self, target):
        self._breaker(target).record_failure()

    def state(self, target) -> str:
        return self._breaker(target).state

    def healthy(self, targets: Iterable) -> Tuple:
        """The subset of `targets` currently allowed (consumes the
        half-open probe slot of any target it admits)."""
        return tuple(t for t in targets if self.allow(t))

    def mask(self, n_targets: int,
             ok: Optional[Iterable[int]] = None) -> np.ndarray:
        """(n_targets,) uint8 health bitmap over integer targets 0..n-1
        for the `with_health=True` distributed search paths. `ok`
        overrides the breaker query (e.g. a precomputed healthy set, so
        one mask serves a whole batch without consuming extra half-open
        probe slots)."""
        ok = self.healthy(range(n_targets)) if ok is None else ok
        m = np.zeros(n_targets, np.uint8)
        for t in ok:
            m[int(t)] = 1
        return m

    def snapshot(self) -> Dict:
        """target -> state, for stats/debugging."""
        with self._lock:
            items = list(self._breakers.items())
        return {t: b.state for t, b in items}


def shards_ok_from_mask(mask) -> Tuple[int, ...]:
    """The SearchResult.shards_ok rendering of a health mask."""
    return tuple(int(i) for i in np.flatnonzero(np.asarray(mask) > 0))
