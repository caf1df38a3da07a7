"""Spans around the calls into the program, and a profiled slice of a run.

`span(name)` marks a harness call ("annbench.<name>") on the host; it costs
a few microseconds and records nothing unless a profiler runs. `profiled`
runs a function under `torch.profiler` (CPU and CUDA activity) and reduces
the trace to device intervals, host spans and the slice's length: what the
per-layer readers and the result's `device` and `breakdown` take.
"""
from __future__ import annotations

import gc
import sys
import time
from contextlib import contextmanager
from typing import List, NamedTuple, Tuple

import torch

PREFIX = "annbench."
WINDOW = PREFIX + "traced_window"
T0 = time.perf_counter()


def note(what: str) -> None:
    """A line on standard error: seconds since the benchmark was imported."""
    print(f"annbench: {time.perf_counter() - T0:9.3f} s {what}", file=sys.stderr, flush=True)


@contextmanager
def span(name: str):
    with torch.profiler.record_function(PREFIX + name):
        yield


@contextmanager
def gc_pauses():
    """The seconds of each collection of the oldest generation inside the
    block, appended to the list it yields."""
    out, t = [], [0.0]

    def cb(phase, info):
        if info.get("generation") != 2:
            return
        if phase == "start":
            t[0] = time.perf_counter()
        else:
            out.append(time.perf_counter() - t[0])
    gc.callbacks.append(cb)
    try:
        yield out
    finally:
        gc.callbacks.remove(cb)


class Trace(NamedTuple):
    kernels: List[Tuple[str, float, float]]   # device (name, start s, duration s), by start
    spans: List[Tuple[str, float, float]]     # host harness spans (name, start s, end s)
    t0: float                                 # the traced window, on the trace's clock
    t1: float

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_s(self) -> float:
        """Seconds in which some device operation ran, inside the window."""
        busy, end = 0.0, self.t0
        for _, s, d in self.kernels:
            a, b = max(s, end), min(s + d, self.t1)
            if b > a:
                busy += b - a
            end = max(end, s + d)
        return busy

    def device_s(self, match) -> float:
        """Device seconds of the operations whose name `match` accepts."""
        return sum(d for n, _, d in self.kernels if match(n))

    def top_ops(self, n: int = 10):
        by: dict = {}
        for name, _, d in self.kernels:
            by[name] = by.get(name, 0.0) + d
        return sorted(([k[:200], v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10):
        """The longest stretches with no device operation, each named by the
        innermost harness span the host was in at its middle."""
        gaps, end = [], self.t0
        for _, s, d in self.kernels:
            if s > end:
                gaps.append((end, min(s, self.t1)))
            end = max(end, s + d)
        if self.t1 > end:
            gaps.append((end, self.t1))
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            mid = (a + b) / 2
            inside = [sp for sp in self.spans if sp[1] <= mid <= sp[2] and sp[0] != WINDOW]
            name = min(inside, key=lambda sp: sp[2] - sp[1])[0] if inside else "no harness span"
            out.append([name, b - a])
        return out


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(ev, f"{what}_us")() * 1000)


def profiled(fn):
    """(fn(), Trace of the call). The device is synchronised inside the
    traced window, so the window ends when the device's work does."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            out = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    kernels, spans, win = [], [], None
    events = prof.profiler.kineto_results.events()
    base = min((_ns(ev, "start") for ev in events), default=0)
    for ev in events:
        name = ev.name()
        start = (_ns(ev, "start") - base) * 1e-9      # seconds from the trace's first event
        dur = _ns(ev, "duration") * 1e-9
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if not name.startswith(PREFIX):      # a span's mirror on the device timeline
                kernels.append((name, start, dur))
        elif name.startswith(PREFIX):
            spans.append((name[len(PREFIX):] if name != WINDOW else name,
                          start, start + dur))
            if name == WINDOW:
                win = (start, start + dur)
    kernels.sort(key=lambda k: k[1])
    if win is None:
        raise RuntimeError("the profiler recorded no traced window")
    return out, Trace(kernels, spans, win[0], win[1])
