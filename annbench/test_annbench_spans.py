"""`annbench/spans.py`: the program's spans placed on a trace's timeline by
the harness's calls, idle time given to the innermost span, and the six
readers of it (None where the program recorded nothing)."""
from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import pytest
import torch

from annbench import harness, span_readings, spans, tracing
from annbench.conftest import tiny

BASE = 1_792_300_000_000_000_000          # a time.time_ns() reading
READERS = {"idle_in_tiles_pct.batch": "glove100.batch",
           "idle_in_tiles_pct.tree": "deep10m.tree-batch",
           "tile_issue_us.batch": "glove100.batch",
           "tile_issue_us.tree": "deep10m.tree-batch",
           "seed_share_pct.build": "glove100.build",
           "idle_in_seed_pct.build": "glove100.build"}


class Rec(NamedTuple):                    # the fields of `repro_torch.spans.Span`
    name: str
    start_ns: int
    end_ns: int
    parent: int
    request: int
    counts: dict
    id: int


def ns(s: float) -> int:
    return BASE + round(s * 1e9)


def search_trace():
    """Two calls. Device busy [0, 1), [3, 4), [5.5, 6); window [0, 7).
    Call 1 on the program's clock: root [0.2, 3.8], tile A [0.5, 2.0] with
    a score stage [1.5, 2.0], tile B [2.0, 3.5]. Call 2: root [5, 6.5],
    one tile [5.2, 6.2]. The harness's spans start 0.1 s later than the
    roots on the trace's timeline (0.1 s + 3 us for the second)."""
    kernels = [("k", 0.0, 1.0), ("k", 3.0, 1.0), ("k", 5.5, 0.5)]
    harness_spans = [("search_request", 0.3, 3.95), ("search_request", 5.100003, 6.6),
                     (tracing.WINDOW, 0.0, 7.0)]
    recs = [Rec("search.score", ns(1.5), ns(2.0), 3, 1, {}, 4),
            Rec("search.tile", ns(0.5), ns(2.0), 1, 1, {"tile": 0}, 3),
            Rec("search.tile", ns(2.0), ns(3.5), 1, 1, {"tile": 1}, 5),
            Rec("engine.search_request", ns(0.2), ns(3.8), 0, 1,
                {"queries": 10, "padded_rows": 16, "tiles": 2}, 1),
            Rec("search.tile", ns(5.2), ns(6.2), 6, 6, {"tile": 0}, 7),
            Rec("engine.search_request", ns(5.0), ns(6.5), 0, 6,
                {"queries": 10, "padded_rows": 16, "tiles": 1}, 6)]
    return tracing.Trace(kernels, harness_spans, 0.0, 7.0), recs


def ctx_of(tr, recs, monkeypatch):
    monkeypatch.setattr(spans, "_records", lambda: (recs, 0))
    return SimpleNamespace(tr=tr)


def test_idle_intervals_are_the_window_less_busy_time():
    tr, _ = search_trace()
    idle = spans.idle_intervals(tr)
    assert idle == [(1.0, 3.0), (4.0, 5.5), (6.0, 7.0)]
    assert sum(b - a for a, b in idle) == pytest.approx(tr.window_s - tr.busy_s())


def test_alignment_by_the_harness_calls():
    tr, recs = search_trace()
    placed, residual = spans.align(tr.spans, recs)
    assert residual == pytest.approx(1.5e-6, abs=1e-9)     # median of 0.1, 0.100003
    at = {(p.name, p.id): p for p in placed}
    # every span moves by one offset: the median of the harness's starts
    # less the roots' (0.1 and 0.100003)
    assert at[("engine.search_request", 1)].start == pytest.approx(0.3000015, abs=1e-12)
    assert at[("search.tile", 3)].start == pytest.approx(0.6000015, abs=1e-12)


def test_calls_that_do_not_pair_read_nothing():
    tr, recs = search_trace()
    assert spans.align(tr.spans, recs[:4]) is None          # one root for two calls
    assert spans.align([s for s in tr.spans if s[0] == tracing.WINDOW], recs) is None


def test_a_gap_split_across_two_spans_and_a_gap_outside_the_program():
    tr, recs = search_trace()
    # place the program exactly on the trace's clock to read whole numbers
    exact = tracing.Trace(tr.kernels, [("search_request", 0.2, 3.9),
                                       ("search_request", 5.0, 6.6)], 0.0, 7.0)
    r = spans.analyse(exact, recs)
    assert r.residual_s == pytest.approx(0.0, abs=1e-12)
    idle = {i: s for i, s in r.idle.items()}
    # gap [1, 3): the score stage [1.5, 2) of tile A, tile A [1, 1.5), tile B [2, 3)
    assert idle[4] == pytest.approx(0.5) and idle[3] == pytest.approx(0.5)
    assert idle[5] == pytest.approx(1.0)
    # gap [4, 5.5): the program is out [4, 5), in its root [5, 5.2), its tile
    # [5.2, 5.5); gap [6, 7): the tile to 6.2, the root to 6.5, then outside
    assert idle[6] == pytest.approx(0.2 + 0.3) and idle[7] == pytest.approx(0.3 + 0.2)
    assert r.outside == pytest.approx(1.0 + 0.5)
    assert sum(idle.values()) + r.outside == pytest.approx(tr.window_s - tr.busy_s())


def test_the_readers_on_a_synthetic_trace(monkeypatch):
    tr, recs = search_trace()
    exact = tracing.Trace(tr.kernels, [("search_request", 0.2, 3.9),
                                       ("search_request", 5.0, 6.6)], 0.0, 7.0)
    ctx = ctx_of(exact, recs, monkeypatch)
    # inside the tiles: 0.5 + 0.5 + 1.0 + 0.5 of the 7-s window
    assert spans.idle_within_pct(ctx, "search.tile") == pytest.approx(100 * 2.5 / 7)
    assert spans.mean_us(ctx, "search.tile") == pytest.approx(1e6 * (1.5 + 1.5 + 1.0) / 3)
    assert spans.share_pct(ctx, "search.tile", "engine.search_request") == pytest.approx(
        100 * 4.0 / (3.6 + 1.5))
    line = spans.summary(ctx.memo["spans"], exact)
    assert "on the device timeline []" in line
    assert "a call (of 2): spans 3.0, tiles 1.5, queries / padded rows 10.0 / 16.0" in line
    # each idle stretch named by the span innermost for most of it: [1, 3)
    # by tile B (1 s of its 2), [4, 5.5) outside (1 s), [6, 7) by the
    # second call's tile and root (0.2 and 0.3 s) and outside (0.5 s)
    assert ("2000.00 search.tile (tile 1), 1500.00 outside the program, "
            "1000.00 outside the program" in line)
    r = ctx.memo["spans"]
    assert [(a, b) for a, b, _ in r.gaps] == [(1.0, 3.0), (4.0, 5.5), (6.0, 7.0)]
    assert [i for _, _, i in r.gaps] == [5, 0, 0]


def test_a_gap_inside_a_tile_stage_names_the_stage_and_its_tile():
    tr, recs = search_trace()
    # busy to 1.5 and from 2.1: the stretch [1.5, 2.1) is the score stage of
    # tile A for 0.5 s and tile B for 0.1 s
    exact = tracing.Trace([("k", 0.0, 1.5), ("k", 2.1, 0.9)] + tr.kernels[1:],
                          [("search_request", 0.2, 3.9), ("search_request", 5.0, 6.6)],
                          0.0, 7.0)
    r = spans.analyse(exact, recs)
    assert r.gaps[0] == pytest.approx((1.5, 2.1, 4))
    assert "600.00 search.score (tile 0)" in spans.summary(r, exact)


def test_escalated_passes_are_counted_in_the_line():
    tr, recs = search_trace()
    recs = recs + [Rec("search.escalate", ns(2.5), ns(3.0), 5, 1, {"rows": 8, "kept": 3}, 8)]
    r = spans.analyse(tr, recs)
    assert "escalated passes 1, rows 8, kept 3; " in spans.summary(r, tr)
    assert "escalated" not in spans.summary(spans.analyse(tr, recs[:-1]), tr)


def test_a_span_named_on_the_device_timeline_is_reported():
    tr, recs = search_trace()
    mirrored = tracing.Trace(tr.kernels + [("search.tile", 6.5, 0.1)], tr.spans, 0.0, 7.0)
    r = spans.analyse(mirrored, recs)
    assert "on the device timeline ['search.tile']" in spans.summary(r, mirrored)


def test_the_build_readers(monkeypatch):
    kernels = [("k", 0.0, 0.5), ("k", 1.5, 0.5)]
    tr = tracing.Trace(kernels, [("build_ivf_sharded", 0.0, 2.0)], 0.0, 2.0)
    recs = [Rec("kmeans.seed", ns(0.4), ns(1.0), 2, 1, {}, 3),
            Rec("build.kmeans", ns(0.1), ns(1.2), 1, 1, {}, 2),
            Rec("build", ns(0.0), ns(2.0), 0, 1, {}, 1)]
    ctx = ctx_of(tr, recs, monkeypatch)
    idle, share = (harness.load(harness.BENCH / "metrics" / f"{n}.py")
                   for n in ("idle_in_seed_pct.build", "seed_share_pct.build"))
    assert idle.read(ctx) == pytest.approx(100 * 0.5 / 2.0)       # idle [0.5, 1.0) in seeding
    assert share.read(ctx) == pytest.approx(100 * 0.6 / 2.0)


@pytest.mark.parametrize("name", sorted(READERS))
@pytest.mark.parametrize("recs", [None, []], ids=["no-module", "no-spans"])
def test_every_reader_reads_none_without_spans(name, recs, monkeypatch):
    tr, _ = search_trace()
    ctx = ctx_of(tr, recs, monkeypatch)
    mod = harness.load(harness.BENCH / "metrics" / f"{name}.py")
    assert mod.SOURCE == "program_span" and mod.read(ctx) is None


@pytest.mark.parametrize("cell", sorted(set(READERS.values())))
def test_a_traced_tiny_cell_reads_its_span_metrics(cell):
    """On the CPU, through the program: every new metric of the cell reads
    a value, and the idle share inside the program is within the idle share."""
    res = harness.run_cell(tiny(cell, trace=True))
    got = {k: v["value"] for k, v in res["metrics"].items()}
    mine = [n for n, c in READERS.items() if c == cell]
    assert all(n in got and got[n] >= 0 for n in mine), got
    idle = got["idle_pct." + cell.split(".")[1].replace("tree-batch", "tree")]
    for n in mine:
        if n.startswith("idle_in_"):
            assert got[n] <= idle + 1e-9


@pytest.mark.parametrize("cell", ["glove100.batch", "glove100.build"])
def test_span_readings_of_a_tiny_cell_in_each_mode(cell):
    """`span_readings.measure` on the CPU: no spans without the profiler,
    and under it the cell's readings, from the program's own clock."""
    acts = {"full": [torch.profiler.ProfilerActivity.CPU]}
    out = span_readings.measure(tiny(cell), 2, 1, acts)
    none, (bare,), (full,) = (out["modes"][m][0] if m == "none" else out["modes"][m]
                              for m in ("none", "spans", "full"))
    assert "spans" not in none and none["call_s"] > 0 and full["spans"] > 0
    # the forced spans record the same spans as the profiler's, without it
    assert bare["spans"] == full["spans"] and "idle_pct" not in bare
    assert 0 < bare["share_pct"] <= 100.0 and bare["mean_us"] > 0
    # no device: the whole window is idle, and the inner spans' share of it
    assert full["idle_pct"] == pytest.approx(100.0)
    assert 0 < full["idle_in_pct"] <= 100.0 and 0 < full["share_pct"] <= 100.0
    assert full["mean_us"] > 0
    from repro_torch import spans as ps
    assert ps._enabled is torch._C._autograd._profiler_enabled     # the switch restored
    if cell.endswith("build"):
        assert 0 < none["kmeans_share_pct"] < 100 and out["inner"] == "kmeans.seed"
    else:
        assert none["call_us_a_tile"] > 0 and out["inner"] == "search.tile"


def test_span_readings_sort_the_device_operations_by_start():
    """Operations given out of order (and named out of order) still make
    the idle stretches of a start-ordered trace."""
    class Ev(NamedTuple):
        n: str
        s: int
        d: int

        def name(self):
            return self.n

        def device_type(self):
            return torch.autograd.DeviceType.CUDA

        def start_ns(self):
            return self.s

        def duration_ns(self):
            return self.d
    recs = [Rec("search.tile", ns(1.0), ns(3.0), 1, 1, {}, 2),
            Rec("engine.search_request", ns(0.0), ns(4.0), 0, 1, {}, 1)]
    events = [Ev("a", ns(3.0), round(1e9)), Ev("b", ns(0.0), round(1.5e9))]
    got = span_readings._readings(events, recs, "engine.search_request", "search.tile")
    assert got["idle_pct"] == pytest.approx(100 * 1.5 / 4)          # idle [1.5, 3)
    assert got["idle_in_pct"] == pytest.approx(100 * 1.5 / 4)
    assert got["share_pct"] == pytest.approx(50.0) and got["mean_us"] == pytest.approx(2e6)
