"""Deterministic fault injection for the durable-storage and serving
paths (the port's own copy of `repro/faults.py`, DESIGN.md §3.11, §3.13).

The port keeps its plans apart from the JAX package's: a test that injects
into the port installs through `repro_torch.faults` (or its shim
`repro_torch.ckpt.faults`). One seam, three families of injection point:

- **byte-budget streams** — ``write(f, data, stream=NAME)``: when an
  installed plan targets ``NAME`` with a byte budget, exactly that many
  bytes are written (flushed + fsynced, so the on-disk prefix is what a
  real crash would leave) and the process dies. Streams:
  ``snapshot:arrays``, ``snapshot:manifest``, ``wal:append``.

- **named crash points** — ``crash_point(NAME)``: dies at the Nth hit of
  a protocol step. Points: ``commit:between_renames``,
  ``commit:before_cleanup``, ``wal:record``.

- **named serving points** — ``serve_point(NAME)``: instead of killing
  the process, fires a *recoverable* fault the serving tier is expected
  to contain — raise ``InjectedFault`` (mode ``"error"``), raise
  ``InjectedTransientFault`` (mode ``"transient"``, classified retryable
  by the serve/api.py taxonomy), sleep ``delay_ms`` (mode ``"delay"``, a
  latency spike), or still die (modes ``"raise"``/``"exit"``). Points
  threaded today: ``engine:search``, ``engine:add``, ``engine:remove``
  (AnnEngine).

Plan grammar (``install(spec)`` / env ``REPRO_FAULT``; ``;``-separated
specs install several plans at once):

    "snapshot:arrays+4096"      die after 4096 bytes of that stream
    "commit:between_renames"    fire at the 1st hit of that point
    "wal:record@3"              fire at the 3rd hit
    "engine:search@2x3"         fire on hits 2,3,4 then go quiet
    "engine:search@1;engine:add@1"   two plans

Point-style plans without an ``xM`` window fire on EVERY hit from the
Nth on (a permanently-down dependency); ``xM`` bounds the outage (a
transient blip of M calls). Modes come from ``mode=`` /
``REPRO_FAULT_MODE`` (``raise`` | ``exit`` | ``error`` | ``transient``
| ``delay``), and ``delay_ms=`` / ``REPRO_FAULT_DELAY_MS`` sizes the
latency spike.

Also home to the **corruption injectors** (``flip_byte``,
``truncate_tail``) the load-path tests use to assert that a damaged
snapshot or WAL surfaces ``CorruptSnapshotError`` instead of garbage.

Zero overhead when nothing is installed: the hot-path checks are a
single ``if not _PLANS`` test. Hit counting is lock-protected — serving
points may be hit from several threads at once.
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional


class InjectedCrash(BaseException):
    """Raised (mode="raise") at an injected crash point. BaseException on
    purpose: recovery code under test must never be able to catch this as
    an ordinary error and "handle" the crash away."""


class InjectedFault(RuntimeError):
    """An ordinary, containable failure fired at a serving point
    (mode="error"): the serving tier is expected to catch it, fail ONLY
    the affected request(s), and keep serving. Non-retryable."""
    retryable = False


class InjectedTransientFault(InjectedFault):
    """A transient serving failure (mode="transient"): classified
    retryable by serve/api.is_retryable, so the front-end's bounded
    retry + backoff should absorb it."""
    retryable = True


@dataclass
class FaultPlan:
    point: str                      # stream / crash-point / serve-point name
    after_bytes: int = -1           # >=0: byte budget for a stream target
    hits: int = 1                   # first firing hit of a named point
    times: Optional[int] = None     # point fires on hits [hits, hits+times)
    mode: str = "raise"             # raise | exit | error | transient | delay
    delay_ms: float = 0.0           # latency spike size for mode="delay"
    _written: int = field(default=0, repr=False)
    _hit_count: int = field(default=0, repr=False)

    @classmethod
    def parse(cls, spec: str, mode: str = "raise",
              delay_ms: float = 0.0) -> "FaultPlan":
        """Parse ONE plan of the grammar (module docstring)."""
        spec = spec.strip()
        if "+" in spec:
            name, _, nb = spec.rpartition("+")
            return cls(point=name, after_bytes=int(nb), mode=mode,
                       delay_ms=delay_ms)
        if "@" in spec:
            name, _, n = spec.rpartition("@")
            times = None
            if "x" in n:
                n, _, t = n.partition("x")
                times = int(t)
            return cls(point=name, hits=int(n), times=times, mode=mode,
                       delay_ms=delay_ms)
        return cls(point=spec, mode=mode, delay_ms=delay_ms)

    def _count_and_check(self) -> bool:
        """Advance the hit counter; True if this hit is inside the firing
        window [hits, hits + times)."""
        self._hit_count += 1
        if self._hit_count < self.hits:
            return False
        return self.times is None or self._hit_count < self.hits + self.times


_PLANS: List[FaultPlan] = []
_LOCK = threading.Lock()


def install(spec: Optional[str] = None, mode: Optional[str] = None,
            delay_ms: Optional[float] = None):
    """Install fault plan(s), REPLACING any currently installed set.
    With no args, reads ``REPRO_FAULT`` / ``REPRO_FAULT_MODE`` /
    ``REPRO_FAULT_DELAY_MS`` from the environment (the subprocess tests'
    channel); no-op if no spec is given. ``;`` separates multiple plans
    in one spec."""
    global _PLANS
    if spec is None:
        spec = os.environ.get("REPRO_FAULT")
    if mode is None:
        mode = os.environ.get("REPRO_FAULT_MODE", "raise")
    if delay_ms is None:
        delay_ms = float(os.environ.get("REPRO_FAULT_DELAY_MS", "0"))
    if not spec:
        return None
    with _LOCK:
        _PLANS = [FaultPlan.parse(s, mode=mode, delay_ms=delay_ms)
                  for s in spec.split(";") if s.strip()]
        return _PLANS[0] if len(_PLANS) == 1 else list(_PLANS)


def inject(spec: str, mode: str = "raise",
           delay_ms: float = 0.0) -> FaultPlan:
    """ADD one plan to the installed set (unlike install, which replaces)
    — lets a chaos test arm several independent points."""
    plan = FaultPlan.parse(spec, mode=mode, delay_ms=delay_ms)
    with _LOCK:
        _PLANS.append(plan)
    return plan


def uninstall():
    global _PLANS
    with _LOCK:
        _PLANS = []


def active() -> Optional[FaultPlan]:
    return _PLANS[0] if _PLANS else None


def _die(plan: FaultPlan):
    if plan.mode == "exit":
        os._exit(42)                 # a real crash: no cleanup of any kind
    raise InjectedCrash(plan.point)


def crash_point(name: str):
    """Named protocol step: dies when an installed plan targets `name`
    (point-style, not byte-budget) and this is the plan's Nth hit."""
    if not _PLANS:
        return
    with _LOCK:
        firing = [p for p in _PLANS
                  if p.after_bytes < 0 and p.point == name
                  and p._count_and_check()]
    for plan in firing:
        _die(plan)


def serve_point(name: str):
    """Named serving step: fires an installed plan targeting `name` as a
    CONTAINABLE fault — raise InjectedFault / InjectedTransientFault,
    sleep a latency spike, or (modes raise/exit) still die, for the
    crash-behind-the-frontend recovery tests. Firing order with several
    armed plans: delays apply first, then the first error-raising plan
    wins."""
    if not _PLANS:
        return
    with _LOCK:
        firing = [p for p in _PLANS
                  if p.after_bytes < 0 and p.point == name
                  and p._count_and_check()]
    err = None
    for plan in firing:
        if plan.mode == "delay":
            time.sleep(plan.delay_ms * 1e-3)
        elif plan.mode == "error" and err is None:
            err = InjectedFault(name)
        elif plan.mode == "transient" and err is None:
            err = InjectedTransientFault(name)
        elif plan.mode in ("raise", "exit"):
            _die(plan)
    if err is not None:
        raise err


def write(f, data: bytes, stream: str):
    """Byte-counted write through the injection seam. When an installed
    plan targets `stream` with a byte budget, writes exactly the budget's
    remaining bytes, forces them to disk (flush + fsync — the on-disk
    state must be the crash state, not "whatever the FILE* buffer held"),
    and dies."""
    plan = next((p for p in _PLANS
                 if p.after_bytes >= 0 and p.point == stream), None)
    if plan is None:
        f.write(data)
        return
    remaining = plan.after_bytes - plan._written
    if len(data) < remaining or remaining < 0:
        f.write(data)
        plan._written += len(data)
        return
    f.write(data[:max(remaining, 0)])
    f.flush()
    os.fsync(f.fileno())
    _die(plan)


# ------------------------------------------------------------ corruption
def flip_byte(path: str, offset: int):
    """XOR one byte at `offset` (negative: from EOF) — the bit-rot
    injector for the load-path CRC tests."""
    with open(path, "r+b") as f:
        size = os.fstat(f.fileno()).st_size
        off = offset if offset >= 0 else size + offset
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))


def truncate_tail(path: str, nbytes: int):
    """Drop the last `nbytes` bytes — the torn-write injector."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(0, size - nbytes))
