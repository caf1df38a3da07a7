"""Spans: named host intervals inside the program, on the clock of
`torch.profiler`'s trace.

    with span("search.tile", tile=i):
        ...

A span records only while a `torch.profiler` profile runs on its thread,
the switch an operator already uses to trace (the profiler records the
thread that started it, and threads that inherit its state, alone);
otherwise entering and leaving one costs a check of the profiler's state.
While it records, each span is kept as a `Span`:

- `start_ns` / `end_ns`: `time.time_ns()`, the domain of the profiler's
  host events, so the spans line up with the profiler's trace;
- `parent`: the id of the span open on the same thread when it began (0
  for none): each thread keeps its own stack, so the front-end's
  dispatcher thread nests its calls apart from its callers';
- `request`: the id of the outermost span, shared by every span of one
  search request or one build;
- `counts`: the keyword counts given when the span was made or to
  `count()` while it ran (the span's, or the module's, which counts into
  the span innermost on the calling thread); a key counted again adds to
  what it holds. A tensor count is kept as the sum of its elements, on
  its device, and read by `spans()`, so counting on the device never
  waits for it.

Each recording span is also an event of the profiler's own trace (a
function-scope record, as an operator's), so an exported chrome trace
shows it; it makes no event on the device timeline. The buffer holds at
most CAPACITY spans and counts those it drops; `spans()` reads it and
`reset()` clears it.

`timed(name, timings, key, device)` is a span that, given a `timings`
dict, adds its wall seconds to `timings[key]` (appends them, with
`append=True`) after waiting for the device's queued work, so a phase is
charged with its own device time. Without a dict it is a plain span.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import List, NamedTuple, Optional

import torch

CAPACITY = 1 << 20

_enabled = torch._C._autograd._profiler_enabled
_Event = torch._C._profiler._RecordFunctionFast
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()
_buf: List["Span"] = []
_dropped = 0


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int          # id of the enclosing span; 0 at a root
    request: int         # id of the root span
    counts: dict
    id: int


class _Off:
    """What a span is while nothing records: a context that does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, **counts) -> None:
        pass


_OFF = _Off()


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def wait(device: Optional[torch.device]) -> None:
    """Wait for the queued work of a CUDA device (nothing for another)."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


def span(name: str, **counts):
    """`with span(name, **counts):` — a recorded interval while a profiler
    runs on this thread, else a shared context that does nothing."""
    if not _enabled():
        return _OFF
    return _Span(name, counts, True)


def recording() -> bool:
    """Whether spans record on this thread (a profiler runs): counts that
    cost work to make are made only then."""
    return _enabled()


def count(**counts) -> None:
    """Add counts to the span innermost on this thread while it records
    (nothing otherwise): code deep inside a phase counts into the phase's
    span without being handed it."""
    if _enabled():
        stack = _stack()
        if stack:
            stack[-1].count(**counts)


def timed(name: str, timings: Optional[dict], key: str,
          device: Optional[torch.device] = None, append: bool = False):
    """A span that also charges its wall seconds, to the end of the
    device's queued work, to `timings[key]` when `timings` is a dict."""
    on = _enabled()
    if not on and timings is None:
        return _OFF
    return _Timed(name, {}, on, timings, key, device, append)


class _Span:
    __slots__ = ("name", "counts", "_on", "id", "parent", "request", "start", "_ev")

    def __init__(self, name: str, counts: dict, on: bool):
        self.name, self.counts, self._on = name, counts, on

    def __enter__(self):
        if self._on:
            stack = _stack()
            top = stack[-1] if stack else None
            self.id = next(_ids)
            self.parent, self.request = (top.id, top.request) if top else (0, self.id)
            stack.append(self)
            self._ev = _Event(self.name)
            self._ev.__enter__()
            self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self._on:
            end = time.time_ns()
            self._ev.__exit__(None, None, None)
            stack = _stack()
            if self in stack:
                stack.remove(self)
            counts = {k: v.sum() if isinstance(v, torch.Tensor) else v
                      for k, v in self.counts.items()}
            _keep(Span(self.name, self.start, end, self.parent, self.request,
                       counts, self.id))
        return False

    def count(self, **counts) -> None:
        for k, v in counts.items():
            if isinstance(v, torch.Tensor):
                v = v.sum()
            self.counts[k] = self.counts[k] + v if k in self.counts else v


class _Timed(_Span):
    __slots__ = ("timings", "key", "device", "append", "t0")

    def __init__(self, name, counts, on, timings, key, device, append):
        super().__init__(name, counts, on)
        self.timings, self.key, self.device, self.append = timings, key, device, append

    def __enter__(self):
        super().__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.timings is not None:
            wait(self.device)
            dt = time.perf_counter() - self.t0
            if self.append:
                self.timings.setdefault(self.key, []).append(dt)
            else:
                self.timings[self.key] = self.timings.get(self.key, 0.0) + dt
        return super().__exit__(*exc)


def _keep(s: Span) -> None:
    global _dropped
    with _lock:
        if len(_buf) < CAPACITY:
            _buf.append(s)
        else:
            _dropped += 1


def spans() -> List[Span]:
    """The recorded spans, in the order they ended, tensor counts summed."""
    with _lock:
        out = list(_buf)
    return [s._replace(counts={k: int(v) if isinstance(v, torch.Tensor) else v
                               for k, v in s.counts.items()}) if s.counts else s
            for s in out]


def dropped() -> int:
    """Spans not kept since the last `reset()`: the buffer was full."""
    return _dropped


def reset() -> None:
    global _dropped
    with _lock:
        _buf.clear()
        _dropped = 0
