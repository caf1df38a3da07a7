"""The filtered cell's pieces at a tiny size on the CPU: its reference
(`reference/filtered.py`), its driver (`drivers/filtered.py`) against an
under-probing program and an older one, and its three readers."""
from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest
import torch

from annbench import harness, program, spans
from annbench.conftest import tiny
from annbench.reference import filtered as rf
from annbench.reference import search as ref

CELL = "glove100.filtered"
READERS = ["probed_per_query.filtered", "scored_slots_per_query.filtered",
           "idle_in_escalate_pct.filtered"]


@pytest.fixture(scope="module")
def served():
    """A tiny cell set up once: its context, the served index's state and
    its filters."""
    ctx = tiny(CELL)
    drv = harness.driver(ctx)
    ctx.state = drv.setup(ctx)
    st = program.index_state(ctx.state["engine"], ctx.state["v"].X)
    return ctx, drv, st


def test_exact_filtered_is_brute_force_over_the_eligible_rows(served):
    ctx, _, _ = served
    v, bits = ctx.state["v"], ctx.state["bits"][0]
    _, ids = rf.exact_filtered(v.X, v.Q, bits, 10)
    s = torch.where(bits[None, :] > 0, v.Q @ v.X.T, float("-inf"))
    want = ref.top_first(s, 10)[1]
    assert torch.equal(ids, want) and bool((bits[ids] > 0).all())
    none = torch.zeros_like(bits)
    assert bool((rf.exact_filtered(v.X, v.Q, none, 10)[1] == -1).all())


@pytest.mark.parametrize("f", [0, 1])
def test_the_reference_does_not_depend_on_its_blocks(served, f, monkeypatch):
    """Queries alone, in blocks of one, give the batched search's answers
    and steps; every step's top_t doubles from the configuration's."""
    ctx, _, st = served
    Q, bits = ctx.state["v"].Q[:24], ctx.state["bits"][f]
    kw = dict(top_t=ctx.cfg["engine"]["top_t"], budget=ctx.cfg["engine"]["rerank_budget"],
              k=10)
    whole = rf.search(st, Q, bits, **kw)
    monkeypatch.setattr(rf, "WINDOW", 1)
    alone = rf.search(st, Q, bits, **kw)
    assert torch.equal(whole.ids, alone.ids) and torch.equal(whole.steps, alone.steps)
    c = st.centroids.shape[0]
    assert torch.equal(whole.top_t, torch.clamp(kw["top_t"] << whole.steps, max=c))
    assert bool((bits[whole.ids.clamp(min=0)] > 0)[whole.ids >= 0].all())


def test_the_population_counts_eligible_ids_the_index_holds(served):
    ctx, _, st = served
    bits = ctx.state["bits"][0]
    assert rf.population(st, bits) == int(bits.sum())     # every row is held
    assert rf.population(st, torch.zeros_like(bits)) == 0


@pytest.mark.parametrize("escalate", [True, False])
def test_an_under_probing_program_fails_miss_share(escalate):
    """The one escalated pass of `escalate=True` (or none) stops thin rows
    short of the budget: the reference's rule finds what it misses."""
    ctx = tiny(CELL, seed=12345)
    ctx.mix["escalate"] = escalate
    res = harness.run_cell(ctx)
    assert not res["correct"]
    assert "miss_share" in {c.name for c in res["checks"] if not c.ok}, \
        harness.check_lines(res)


def test_a_program_without_the_mode_stops_before_any_work(monkeypatch):
    ctx = tiny(CELL)
    _, SearchParams, _, _ = program.api()
    monkeypatch.delattr(sys.modules[SearchParams.__module__], "ESCALATE_MODES")
    drv = harness.driver(ctx)
    with pytest.raises(ValueError, match="no escalate='budget' mode"):
        drv.setup(ctx)
    assert ctx.state is None


def test_a_window_runs_whole_rounds_of_the_filters(served):
    """Every filter gets as many calls, however short the window, so the
    per-query counts of a traced slice weigh the filters alike."""
    ctx, drv, _ = served
    for loop in (drv.window, drv.traced):
        rec = loop(ctx, 0.0)
        assert rec["passes"] == len(ctx.mix["filters"])


def test_the_filters_come_from_the_seed(served):
    ctx, drv, _ = served
    a, b = drv.filters(ctx, 100_000), drv.filters(ctx, 100_000)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    other = drv.filters(tiny(CELL, seed=5), 100_000)
    assert not torch.equal(a[0], other[0])
    for bits, f in zip(a, ctx.mix["filters"]):
        assert abs(float(bits.float().mean()) / f["selectivity"] - 1) < 0.15


def test_the_counters_per_query_on_a_synthetic_reading(monkeypatch):
    placed = [spans.Placed("engine.search_request", 0.0, 1.0, 1, 0, 1, {"queries": 10}),
              spans.Placed("search.tile", 0.1, 0.5, 2, 1, 1,
                           {"tile": 0, "probed": 40, "scored": 100}),
              spans.Placed("search.escalate", 0.2, 0.4, 3, 2, 1,
                           {"rows": 4, "probed": 32, "scored": 60}),
              spans.Placed("engine.search_request", 1.0, 2.0, 4, 0, 4, {"queries": 10}),
              spans.Placed("search.tile", 1.1, 1.5, 5, 4, 4,
                           {"tile": 0, "probed": 40, "scored": 90})]
    reading = spans.Reading(placed, {3: 0.1}, 0.0, [], 0.0)
    ctx = SimpleNamespace(tr=SimpleNamespace(window_s=2.0))
    monkeypatch.setattr(spans, "reading", lambda _ctx: reading)
    got = {n: harness.load(harness.BENCH / "metrics" / f"{n}.py").read(ctx) for n in READERS}
    assert got["probed_per_query.filtered"] == pytest.approx((40 + 32 + 40) / 20)
    assert got["scored_slots_per_query.filtered"] == pytest.approx((100 + 60 + 90) / 20)
    assert got["idle_in_escalate_pct.filtered"] == pytest.approx(100 * 0.1 / 2.0)


@pytest.mark.parametrize("name", READERS)
def test_every_reader_reads_none_without_the_counts(name, monkeypatch):
    ctx = SimpleNamespace(tr=SimpleNamespace(window_s=2.0))
    mod = harness.load(harness.BENCH / "metrics" / f"{name}.py")
    monkeypatch.setattr(spans, "reading", lambda _ctx: None)
    assert mod.read(ctx) is None
    plain = [spans.Placed("engine.search_request", 0.0, 1.0, 1, 0, 1, {"queries": 10}),
             spans.Placed("search.tile", 0.1, 0.5, 2, 1, 1, {"tile": 0})]
    monkeypatch.setattr(spans, "reading", lambda _ctx: spans.Reading(plain, {}, 0.0, [], 0.0))
    assert mod.read(ctx) is None


def test_a_traced_tiny_cell_reads_its_metrics():
    res = harness.run_cell(tiny(CELL, trace=True))
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(got) == set(READERS)
    cfg = tiny(CELL).cfg
    top_t, c = cfg["engine"]["top_t"], cfg["index"]["n_partitions"]
    assert top_t <= got["probed_per_query.filtered"] <= 2 * c
    assert 0 < got["scored_slots_per_query.filtered"]
    assert 0 <= got["idle_in_escalate_pct.filtered"] <= 100
