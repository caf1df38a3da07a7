"""`repro_torch.spans`: spans record only under a running profiler, nest
by thread, share one request id a call, leave results and `timings` as
they were, and keep a bounded buffer."""
from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.core.build import build_ivf_sharded
from repro_torch.core.kmeans import train_kmeans
from repro_torch.data.vectors import make_manifold
from repro_torch.quant.pq import train_pq
from repro_torch.serve.api import SearchParams
from repro_torch.serve.engine import AnnEngine
from repro_torch.spans import span, timed

# a PQ pass's stages: its scorer keeps each row's top slots, so no window
# of ids is gathered ("search.gather" is the window path's)
TILE_STAGES = {"search.route", "search.lut", "search.score", "search.dedup",
               "search.rerank"}
PHASES = {"kmeans", "spill_assign", "router", "csr", "pq_train", "encode", "rerank"}


def profiling():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def empty_buffer():
    spans.reset()
    yield
    spans.reset()


@pytest.fixture(scope="module")
def data():
    ds = make_manifold(3, 4000, 16, nq=40, intrinsic_dim=6, device="cpu")
    return ds.X, ds.Q


@pytest.fixture(scope="module")
def engine(data):
    X, _ = data
    return AnnEngine.build(torch.Generator().manual_seed(5), X, 24, pq_subspaces=8,
                           top_t=6, rerank_budget=48, bq=16, train_sample=2048,
                           shard_size=1024, device="cpu")


def children(recs, parent):
    return [s for s in recs if s.parent == parent.id]


def test_nothing_records_without_a_profiler(engine, data):
    _, Q = data
    with span("outer", n=1) as s:
        with span("inner"):
            s.count(n=2)
    with timed("phase", None, "phase"):
        pass
    engine.search_request(Q.numpy(), SearchParams(k=10))
    assert spans.spans() == [] and spans.dropped() == 0


def test_timed_charges_a_dict_without_recording():
    t = {}
    with timed("phase", t, "a"):
        time.sleep(0.002)
    with timed("phase", t, "a"):
        pass
    with timed("lap", t, "b", append=True):
        pass
    assert t["a"] >= 0.002 and len(t["b"]) == 1 and spans.spans() == []


def test_spans_nest_and_self_time_is_duration_less_children():
    with profiling():
        with span("root", what=7) as root:
            time.sleep(0.004)
            with span("child"):
                time.sleep(0.006)
                with span("grandchild"):
                    pass
            root.count(more=1)
        with span("second"):
            pass
    recs = spans.spans()
    names = [s.name for s in recs]
    assert names == ["grandchild", "child", "root", "second"]     # the order they ended
    r = {s.name: s for s in recs}
    assert r["root"].parent == 0 and r["child"].parent == r["root"].id
    assert r["grandchild"].parent == r["child"].id
    assert r["root"].counts == {"what": 7, "more": 1}
    assert {s.request for s in recs[:3]} == {r["root"].id}
    assert r["second"].request == r["second"].id != r["root"].id
    dur = {k: s.end_ns - s.start_ns for k, s in r.items()}
    self_ns = dur["root"] - sum(dur[c.name] for c in children(recs, r["root"]))
    assert 0.004e9 <= self_ns < dur["root"] and dur["child"] >= 0.006e9
    assert r["child"].start_ns >= r["root"].start_ns and r["child"].end_ns <= r["root"].end_ns


def test_stamps_are_on_the_profilers_clock():
    """The profiler stamps an event between the `time.time_ns()` reads taken
    around its entry, and a span's own event where the span starts (to the
    profiler's clock conversion, microseconds; a busy host may stall the
    thread between two reads, which the bracket allows for)."""
    with profiling() as prof:
        a = time.time_ns()
        with torch.profiler.record_function("beside"):
            b = time.time_ns()
            with span("mine"):
                pass
    events = prof.profiler.kineto_results.events()
    (ev,) = [e for e in events if e.name() == "beside"]
    (mine,) = spans.spans()
    assert a - 1e5 <= ev.start_ns() <= b + 1e5
    assert b <= mine.start_ns <= mine.end_ns
    # the span is also an event of the profiler's own trace, entered just
    # before the span's stamp
    (own,) = [e for e in events if e.name() == "mine"]
    assert b - 1e5 <= own.start_ns() <= mine.start_ns + 1e5


class _NoEvent:
    def __init__(self, name):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_each_thread_nests_on_its_own(monkeypatch):
    """Every thread keeps its own stack of open spans (recording forced on
    here: a profiler records the thread that started it alone)."""
    monkeypatch.setattr(spans, "_enabled", lambda: True)
    monkeypatch.setattr(spans, "_Event", _NoEvent)
    inside, done = threading.Event(), threading.Event()

    def worker():
        with span("thread.root"):
            inside.set()
            done.wait(timeout=30)
            with span("thread.child"):
                pass

    with span("main.root"):
        t = threading.Thread(target=worker)
        t.start()
        inside.wait(timeout=30)
        with span("main.child"):
            done.set()
        t.join(timeout=30)
    seen = {s.name: s for s in spans.spans()}
    assert seen["thread.root"].parent == 0 and seen["main.root"].parent == 0
    assert seen["thread.child"].parent == seen["thread.root"].id
    assert seen["main.child"].parent == seen["main.root"].id
    assert seen["thread.child"].request != seen["main.child"].request


def test_a_thread_outside_the_profiler_records_nothing():
    def worker():
        with span("elsewhere"):
            pass

    with profiling():
        with span("here"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
    assert [s.name for s in spans.spans()] == ["here"]


def test_one_search_request_shares_one_request_id(engine, data):
    _, Q = data
    with profiling():
        engine.search_request(Q.numpy(), SearchParams(k=10))
    recs = spans.spans()
    (root,) = [s for s in recs if s.parent == 0]
    assert root.name == "engine.search_request"
    assert {s.request for s in recs} == {root.id}
    assert root.counts == {"queries": 40, "padded_rows": 48, "tiles": 3}
    kids = [s.name for s in sorted(children(recs, root), key=lambda s: s.start_ns)]
    assert kids == ["engine.prepare", "engine.copy_in"] + ["search.tile"] * 3 + ["engine.copy_out"]
    tiles = [s for s in recs if s.name == "search.tile"]
    assert sorted(s.counts["tile"] for s in tiles) == [0, 1, 2]
    for tile in tiles:
        assert {s.name for s in children(recs, tile)} == TILE_STAGES
        for s in children(recs, tile):
            assert tile.start_ns <= s.start_ns <= s.end_ns <= tile.end_ns
        (score,) = [s for s in children(recs, tile) if s.name == "search.score"]
        assert score.counts == {"selected": 16}         # every row of the tile


def test_escalation_is_a_span_with_its_counts(engine, data):
    _, Q = data
    few = np.arange(0, 4000, 50)
    with profiling():
        r = engine.search_request(Q[:16].numpy(), SearchParams(k=10, filter_ids=few))
    esc = [s for s in spans.spans() if s.name == "search.escalate"]
    assert r.escalated and len(esc) == 1
    assert esc[0].counts["rows"] == 16 and 0 <= esc[0].counts["kept"] <= 16
    assert isinstance(esc[0].counts["kept"], int)
    inner = [s for s in spans.spans() if s.parent == esc[0].id]
    assert {s.name for s in inner} == TILE_STAGES


def test_each_budget_step_is_a_span_with_its_counts(engine, data):
    """`escalate="budget"` on the flat router: one "search.escalate" span
    for the tile's thin rows, every one of them settled by the count, its
    `step` and `top_t` the widest settled (top_t doubled each step from
    the engine's 6), one pass a step present (`passes`, each its own
    stages), and the tile's and the settle's counters (probed partitions,
    the slots under them, the eligible ones scored)."""
    _, Q = data
    few = np.arange(0, 4000, 100)            # 40 ids of 4,000
    with profiling():
        r = engine.search_request(Q[:16].numpy(), SearchParams(k=10, filter_ids=few,
                                                               escalate="budget"))
    recs = spans.spans()
    (esc,) = [s for s in recs if s.name == "search.escalate"]
    assert r.escalated
    n, step, passes = esc.counts["rows"], esc.counts["step"], esc.counts["passes"]
    assert 0 < n <= 16 and esc.counts["settled"] == esc.counts["kept"] == n
    assert esc.counts["top_t"] == min(6 << step, 24) and 1 <= passes <= step
    (tile,) = [s for s in recs if s.name == "search.tile"]
    for s in (tile, esc):
        assert all(isinstance(s.counts[k], int) for k in ("probed", "gathered", "scored"))
        assert 0 < s.counts["scored"] < s.counts["gathered"]
    assert tile.counts["probed"] == 16 * 6
    assert esc.parent == tile.id
    assert n * 12 <= esc.counts["probed"] <= n * esc.counts["top_t"]
    if passes == 1:
        assert esc.counts["probed"] == n * esc.counts["top_t"]
    stages = [c.name for c in children(recs, esc)]
    assert set(stages) == TILE_STAGES and stages.count("search.route") == passes


def test_results_are_the_same_bits_with_the_profiler_on(engine, data):
    _, Q = data
    off = engine.search_request(Q.numpy(), SearchParams(k=10))
    with profiling():
        on = engine.search_request(Q.numpy(), SearchParams(k=10))
    assert np.array_equal(off.ids, on.ids) and np.array_equal(off.scores, on.scores)
    assert off.scores.tobytes() == on.scores.tobytes()


def test_build_timings_keep_their_keys_and_the_build_spans_appear(data):
    X, _ = data
    kw = dict(pq_subspaces=8, train_sample=2048, shard_size=1024, train_iters=4,
              device="cpu")
    t_off = {}
    a = build_ivf_sharded(torch.Generator().manual_seed(2), X, 24, timings=t_off, **kw)
    assert set(t_off) == PHASES and spans.spans() == []
    t_on = {}
    with profiling():
        b = build_ivf_sharded(torch.Generator().manual_seed(2), X, 24, timings=t_on, **kw)
    assert set(t_on) == PHASES
    assert torch.equal(a.codes, b.codes) and torch.equal(a.centroids, b.centroids)
    recs = spans.spans()
    (root,) = [s for s in recs if s.parent == 0]
    assert root.name == "build" and {s.request for s in recs} == {root.id}
    phases = {s.name: s for s in children(recs, root)}
    assert set(phases) == {"build." + p for p in PHASES}
    under = lambda p: {s.name for s in children(recs, phases["build." + p])}  # noqa: E731
    assert under("kmeans") == {"kmeans.sample", "kmeans.seed", "kmeans.lloyd"}
    assert under("pq_train") == {"pq.sample", "pq.seed", "pq.lloyd"}
    for name, key in (("build." + p, p) for p in PHASES):
        s = phases[name]
        assert (s.end_ns - s.start_ns) * 1e-9 >= t_on[key] * 0.5


def test_the_variant_build_spans_appear(data):
    """Two SOAR spills, an anisotropic codebook and int8 rows: the
    codebook's "anisotropic.assign" (a round and the final one) and
    "anisotropic.update" (a round) under "build.kmeans", the third
    column's "build.spill_columns" once a shard under
    "build.spill_assign", and "int8.quantize" under "build.rerank"."""
    X, _ = data
    with profiling():
        build_ivf_sharded(torch.Generator().manual_seed(2), X, 24, pq_subspaces=8,
                          train_sample=2048, shard_size=1024, train_iters=12, n_spills=2,
                          anisotropic_T=0.2, rerank="int8", device="cpu")
    recs = spans.spans()
    (root,) = [s for s in recs if s.parent == 0]
    phases = {s.name: s for s in children(recs, root)}
    under = lambda p: [s.name for s in children(recs, phases["build." + p])]  # noqa: E731
    kmeans = under("kmeans")
    assert set(kmeans) == {"kmeans.sample", "kmeans.seed", "kmeans.lloyd",
                           "anisotropic.assign", "anisotropic.update"}
    assert kmeans.count("anisotropic.update") == 4 and kmeans.count("anisotropic.assign") == 5
    assert under("spill_assign") == ["build.spill_columns"] * 4      # 4,000 rows, shards of 1,024
    assert under("rerank") == ["int8.quantize"]


@pytest.mark.parametrize("rerank", ["f32", "int8"])
def test_the_rerank_counts_its_rows_and_bytes(data, rerank):
    """"search.rerank" counts the valid candidates of the call's queries
    (`rows`, the pad rows of the last tile left out) and the bytes of rows
    and scales it read: d + 4 a valid candidate from int8 rows, 4d every
    slot from f32 rows."""
    X, Q = data
    eng = AnnEngine.build(torch.Generator().manual_seed(5), X, 24, pq_subspaces=8,
                          top_t=6, rerank_budget=48, bq=16, train_sample=2048,
                          shard_size=1024, rerank=rerank, device="cpu")
    with profiling():
        eng.search_request(Q.numpy(), SearchParams(k=10))
    rr = [s for s in spans.spans() if s.name == "search.rerank"]
    assert len(rr) == 3
    rows = sum(s.counts["rows"] for s in rr)
    nbytes = sum(s.counts["row_bytes"] for s in rr)
    assert all(isinstance(s.counts["row_bytes"], int) for s in rr)
    assert 40 * 10 <= rows <= 40 * 48
    assert nbytes == (rows * (16 + 4) if rerank == "int8" else 40 * 48 * 4 * 16)


def test_count_adds_to_the_innermost_span_of_its_thread():
    """`spans.count` counts into the span innermost on the calling thread
    while a profiler records, and does nothing otherwise."""
    spans.count(n=1)
    with span("outer"):
        spans.count(n=1)
    assert spans.spans() == []
    with profiling():
        spans.count(stray=1)
        with span("outer", a=1):
            with span("inner"):
                spans.count(n=2)
            spans.count(m=3)
    assert {s.name: s.counts for s in spans.spans()} == {"inner": {"n": 2},
                                                         "outer": {"a": 1, "m": 3}}


def test_a_key_counted_again_adds_to_its_count():
    """Counts of one key add up, tensors (of any shapes) by their sums."""
    with profiling():
        with span("outer", a=1) as s:
            s.count(a=2)
            spans.count(t=torch.ones(2, 3, dtype=torch.bool))
            spans.count(t=torch.ones(4, dtype=torch.int32), a=torch.tensor(3))
    (rec,) = spans.spans()
    assert rec.counts == {"a": 6, "t": 10}
    assert all(isinstance(v, int) for v in rec.counts.values())


def test_seed_spans_count_their_picks(data):
    """"kmeans.seed" and "pq.seed" count the k-means++ picks; on the CPU
    the plain loop makes them, so none is a fused one (the kernel's)."""
    X, _ = data
    with profiling():
        train_kmeans(torch.Generator().manual_seed(0), X, 24, iters=2)
        train_pq(torch.Generator().manual_seed(0), X, 8, iters=2)
    seeds = {s.name: s.counts for s in spans.spans() if s.name.endswith(".seed")}
    assert seeds == {"kmeans.seed": {"picks": 23}, "pq.seed": {"picks": 15 * 8}}


def test_the_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(spans, "CAPACITY", 5)
    with profiling():
        for i in range(8):
            with span("s", i=i):
                pass
    recs = spans.spans()
    assert len(recs) == 5 and spans.dropped() == 3
    assert [s.counts["i"] for s in recs] == [0, 1, 2, 3, 4]
    spans.reset()
    assert spans.spans() == [] and spans.dropped() == 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_on_the_card_no_span_is_on_the_device_timeline(card):
    """Under a CPU + CUDA profiler a span makes no event on the device
    timeline (`record_function`, the control, does), and the profiler's
    stamp of a span's own event lies within 10 us of the span's."""
    x = torch.randn(1 << 20, device=card)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(50):
            with torch.profiler.record_function("control"):
                with span("card.span"):
                    (x * 2).sum()
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    on_device = {e.name() for e in events if e.device_type() == torch.autograd.DeviceType.CUDA}
    assert "control" in on_device and "card.span" not in on_device
    own = sorted(e.start_ns() for e in events if e.name() == "card.span"
                 and e.device_type() != torch.autograd.DeviceType.CUDA)
    mine = sorted(s.start_ns for s in spans.spans() if s.name == "card.span")
    assert len(own) == len(mine) == 50
    gaps = sorted(abs(m - o) for m, o in zip(mine, own))
    assert gaps[len(gaps) // 2] < 10_000, gaps


@pytest.mark.cuda
def test_on_the_card_a_span_costs_under_a_microsecond_with_tracing_off(card):
    """200,000 spans with no profiler running, best of seven rounds, less
    the empty loop: at most 1 us a span on the card's host."""
    def per_call_us(body):
        best = float("inf")
        for _ in range(7):
            t = time.perf_counter()
            for i in range(200_000):
                body(i)
            best = min(best, (time.perf_counter() - t) / 200_000)
        return best * 1e6

    def empty(i):
        pass

    def one(i):
        with span("card.tile", tile=i):
            pass
    cost = per_call_us(one) - per_call_us(empty)
    assert cost <= 1.0, cost
    assert spans.spans() == []
