"""The program's own spans (`repro_torch.spans`) on the traced slice's
timeline, and the device's idle time given to the span the host was in.

The program records its spans only while a profiler runs, so its buffer
holds the traced slice's spans, stamped in `time.time_ns()` nanoseconds.
One offset places them on the trace's timeline (seconds from its first
event): the median, over the harness's spans around its calls into the
program, paired one to one in order with the program's root spans of
those calls (`search_request` with "engine.search_request",
`build_ivf_sharded` with "build"), of the harness span's start less the
program root's. The residual is the widest deviation from that median.

Each idle second of the slice (no device operation running) then goes to
the innermost program span that covers it, or to OUTSIDE. The program is
imported after `program._path()`; where it has no spans (an older
checkout), every reading here is None.
"""
from __future__ import annotations

import statistics
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

from annbench import program, tracing

ROOTS = {"search_request": "engine.search_request", "build_ivf_sharded": "build"}
OUTSIDE = "outside the program"


class Placed(NamedTuple):
    name: str
    start: float          # seconds on the trace's timeline
    end: float
    id: int
    parent: int
    request: int
    counts: dict


class Reading(NamedTuple):
    spans: List[Placed]
    idle: Dict[int, float]         # span id → idle seconds it was innermost for
    outside: float                 # idle seconds in no program span
    gaps: List[Tuple[float, float, int]]   # (start, end, id of the span innermost
    residual_s: float                      #  for most of the stretch; 0: outside)


def idle_intervals(tr: tracing.Trace) -> List[Tuple[float, float]]:
    """The stretches of the traced window in which no device operation ran."""
    out, end = [], tr.t0
    for _, s, d in tr.kernels:
        if s > end:
            out.append((end, min(s, tr.t1)))
        end = max(end, s + d)
        if end >= tr.t1:
            break
    if tr.t1 > end:
        out.append((end, tr.t1))
    return [(a, b) for a, b in out if b > a]


def align(harness_spans, recs) -> Optional[Tuple[List[Placed], float]]:
    """(the slice's program spans on the trace's timeline, residual s), or
    None where the harness's calls and the program's roots do not pair."""
    calls = sorted((s for s in harness_spans if s[0] in ROOTS), key=lambda s: s[1])
    if not calls:
        return None
    root = ROOTS[calls[0][0]]
    roots = sorted((r for r in recs if r.parent == 0 and r.name == root),
                   key=lambda r: r.start_ns)[-len(calls):]   # the slice's: the last ones
    if len(roots) != len(calls):
        return None
    p0 = roots[0].start_ns
    diffs = [c[1] - (r.start_ns - p0) * 1e-9 for c, r in zip(calls, roots)]
    off = statistics.median(diffs)
    placed = [Placed(r.name, (r.start_ns - p0) * 1e-9 + off, (r.end_ns - p0) * 1e-9 + off,
                     r.id, r.parent, r.request, r.counts)
              for r in recs if r.start_ns >= p0]
    return placed, max(abs(d - off) for d in diffs)


def _depths(placed: List[Placed]) -> Dict[int, int]:
    """Each span's nesting depth (0 at a root or below a span not kept)."""
    by_id = {p.id: p for p in placed}
    depth: Dict[int, int] = {}

    def depth_of(i: int) -> int:
        if i not in depth:
            par = by_id[i].parent
            depth[i] = 1 + depth_of(par) if par in by_id else 0
        return depth[i]
    for p in placed:
        depth_of(p.id)
    return depth


def attribute(idle: List[Tuple[float, float]], placed: List[Placed]):
    """({span id: idle seconds for which it was the innermost covering
    span}, idle seconds in no span, [(start, end, id of the span innermost
    for most of it, 0 for none) for each idle stretch]). Depth orders
    nesting; of two spans at one depth, the later started is the inner."""
    by_id = {p.id: p for p in placed}
    depth = _depths(placed)
    pts = []
    for p in placed:
        if p.end > p.start:
            pts.append((p.start, 1, p.id))
            pts.append((p.end, -1, p.id))
    for g, (a, b) in enumerate(idle):
        pts.append((a, 2, g))
        pts.append((b, -2, g))
    pts.sort(key=lambda x: x[0])
    out: Dict[int, float] = defaultdict(float)
    per_gap: List[Dict[int, float]] = [defaultdict(float) for _ in idle]
    active, idle_on, gap, prev = {}, 0, 0, None
    for t, kind, i in pts:
        if idle_on > 0 and prev is not None and t > prev:
            inner = max(active, key=lambda j: active[j]) if active else 0
            out[inner] += t - prev
            per_gap[gap][inner] += t - prev
        prev = t
        if kind == 1:
            active[i] = (depth[i], by_id[i].start)
        elif kind == -1:
            active.pop(i, None)
        else:
            idle_on += 1 if kind == 2 else -1
            gap = i
    outside = out.pop(0, 0.0)
    gaps = [(a, b, max(w, key=w.get) if w else 0) for (a, b), w in zip(idle, per_gap)]
    return dict(out), outside, gaps


def analyse(tr: tracing.Trace, recs) -> Optional[Reading]:
    got = align(tr.spans, recs)
    if got is None:
        return None
    placed, residual = got
    return Reading(placed, *attribute(idle_intervals(tr), placed), residual)


def _records():
    program._path()
    try:
        from repro_torch import spans as ps
    except ImportError:
        return None, 0
    recs, dropped = ps.spans(), ps.dropped()
    ps.reset()
    return recs, dropped


def reading(ctx) -> Optional[Reading]:
    """The traced slice's reading, worked out once a run (None where the
    program recorded no spans that pair with the harness's calls)."""
    memo = ctx.__dict__.setdefault("memo", {})
    if "spans" not in memo:
        recs, dropped = _records()
        memo["spans"] = r = analyse(ctx.tr, recs) if recs else None
        if r is not None:
            tracing.note(summary(r, ctx.tr, dropped))
    return memo["spans"]


def _within(r: Reading, name: str) -> set:
    """Ids of the spans named `name` and of every span inside one."""
    by_id = {p.id: p for p in r.spans}
    inside: Dict[int, bool] = {}

    def test(i: int) -> bool:
        if i not in inside:
            p = by_id.get(i)
            inside[i] = p is not None and (p.name == name or test(p.parent))
        return inside[i]
    return {p.id for p in r.spans if test(p.id)}


def idle_within_pct(ctx, name: str) -> Optional[float]:
    """Idle seconds while the host was inside a `name` span, over the
    slice's seconds, in %."""
    r = reading(ctx)
    if r is None or not any(p.name == name for p in r.spans):
        return None
    ids = _within(r, name)
    return 100.0 * sum(s for i, s in r.idle.items() if i in ids) / ctx.tr.window_s


def mean_us(ctx, name: str) -> Optional[float]:
    """Mean host microseconds of a `name` span."""
    r = reading(ctx)
    d = [p.end - p.start for p in r.spans if p.name == name] if r else []
    return 1e6 * sum(d) / len(d) if d else None


def share_pct(ctx, name: str, of: str) -> Optional[float]:
    """Host seconds of the `name` spans over those of the `of` spans, in %."""
    r = reading(ctx)
    if r is None:
        return None
    part = sum(p.end - p.start for p in r.spans if p.name == name)
    whole = sum(p.end - p.start for p in r.spans if p.name == of)
    return 100.0 * part / whole if part > 0 and whole > 0 else None


def _label(by_id: Dict[int, Placed], i: int) -> str:
    """A span's name, with the index of the search tile it lies in."""
    if i not in by_id:
        return OUTSIDE
    name, p = by_id[i].name, by_id[i]
    while p is not None and p.name != "search.tile":
        p = by_id.get(p.parent)
    return name + (f" (tile {p.counts['tile']})" if p is not None and "tile" in p.counts else "")


def summary(r: Reading, tr: tracing.Trace, dropped: int = 0) -> str:
    """One line: the alignment, any program span named on the device
    timeline, the calls (spans, tiles, queries and padded rows a call),
    the escalated passes, the idle seconds by innermost span, the longest
    idle gaps named by the span innermost for most of each (and its tile),
    and the host seconds by span."""
    names = {p.name for p in r.spans}
    mirrors = sorted(names & {k[0] for k in tr.kernels})
    idle: Dict[str, float] = defaultdict(float)
    host: Dict[str, List[float]] = defaultdict(list)
    by_id = {p.id: p for p in r.spans}
    for i, s in r.idle.items():
        idle[by_id[i].name] += s
    idle[OUTSIDE] += r.outside
    for p in r.spans:
        host[p.name].append(p.end - p.start)
    calls = max(len({p.request for p in r.spans}), 1)

    def total(key: str, name: Optional[str] = None) -> int:
        return sum(p.counts.get(key, 0) for p in r.spans if name in (None, p.name))
    esc = host.get("search.escalate", [])
    top = sorted(idle.items(), key=lambda kv: -kv[1])[:8]
    gaps = sorted(r.gaps, key=lambda g: g[0] - g[1])[:5]
    return ("program spans: " + f"{len(r.spans)} kept, {dropped} dropped, residual "
            f"{r.residual_s * 1e6:.1f} us, on the device timeline {mirrors}; "
            + f"a call (of {calls}): spans {len(r.spans) / calls:.1f}"
            + (f", tiles {total('tiles') / calls:.1f}, queries / padded rows "
               f"{total('queries') / calls:.1f} / {total('padded_rows') / calls:.1f}"
               if total("padded_rows") else "") + "; "
            + (f"escalated passes {len(esc)}, rows {total('rows', 'search.escalate')}, "
               f"kept {total('kept', 'search.escalate')}; " if esc else "")
            + "idle s by innermost span " + ", ".join(f"{k} {v:.4f}" for k, v in top)
            + "; longest gaps (ms, innermost span for most of it) " + ", ".join(
                f"{1e3 * (b - a):.2f} {_label(by_id, i)}" for a, b, i in gaps)
            + "; host s (count, mean us) " + ", ".join(
                f"{k} {sum(v):.4f} ({len(v)}, {1e6 * sum(v) / len(v):.1f})"
                for k, v in sorted(host.items(), key=lambda kv: -sum(kv[1]))))
