"""The port's filtered search under `escalate="budget"` against the plain
reference `tests/filtered_ref.py`, on the CPU and without JAX.

The index is test_torch_filtered.py's shape (n=20k, d=32, c=64, m=8),
built here by the port itself; the tree router is the port's default (S =
8 supers, t_route = 1). The reference walks each query, alone, up the
router's escalation steps until its unique eligible candidates reach
min(rerank budget, population); the port does that on whole tiles, for
the thin rows alone, over the index cut to the filter's eligible slots.
"""
import numpy as np
import pytest
import torch

import filtered_ref as fr
from repro_torch import spans
from repro_torch.core import pack_ivf, search_jit, search_jit_batched
from repro_torch.core.build import build_ivf_sharded
from repro_torch.core.mutable import MutableIVF
from repro_torch.core.router import FlatRouter, train_tree_router
from repro_torch.core.search import ESCALATE_BUDGET, _subset, filtered_pack, settle_steps
from repro_torch.data.vectors import make_manifold
from repro_torch.serve.api import ESCALATE_MODES, SearchParams
from repro_torch.serve.engine import AnnEngine
from repro_torch.serve.frontend import ServingFrontend

N, D, C, M, NQ = 20_000, 32, 64, 8, 200
TOP_T, K, BUDGET, BQ = 8, 10, 64, 64
KW = dict(top_t=TOP_T, final_k=K, rerank_budget=BUDGET)


def _bitmap(selectivity, seed=7):
    rng = np.random.default_rng(seed)
    bits = np.zeros(N, np.uint8)
    bits[rng.choice(N, int(round(selectivity * N)), replace=False)] = 1
    return bits


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs under several workers, and the
    reference's many small ops crawl when their threads oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def profiling():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def data():
    ds = make_manifold(0, N, D, nq=NQ, device="cpu")
    return ds.X, ds.Q


@pytest.fixture(scope="module")
def index(data):
    return build_ivf_sharded(torch.Generator().manual_seed(0), data[0], C,
                             spill_mode="soar", lam=1.0, pq_subspaces=M, device="cpu")


@pytest.fixture(scope="module")
def packed(index):
    return pack_ivf(index)


@pytest.fixture(scope="module")
def routers(index):
    return {"flat": FlatRouter(index.centroids),
            "tree": train_tree_router(torch.Generator().manual_seed(2), index.centroids)}


def _ref_index(packed, router):
    tree = None
    if router is not None and hasattr(router, "super_centroids"):
        tree = fr.Tree(router.super_centroids, router.children, router.child_centroids,
                       router.t_route)
    return fr.Index(packed.centroids, packed.part_ids, packed.part_codes,
                    packed.pq.centers, packed.rerank, tree)


_REFS = {}


def _ref(packed, routers, router, selectivity, Q, seed=7):
    key = (router, selectivity, seed, Q.shape[0])
    if key not in _REFS:
        _REFS[key] = fr.search(_ref_index(packed, routers[router]), Q,
                               torch.from_numpy(_bitmap(selectivity, seed)), **{
                                   "top_t": TOP_T, "k": K, "budget": BUDGET})
    return _REFS[key]


def _escalations(fn):
    """fn() under the profiler → (its result, the spans it recorded)."""
    spans.reset()
    with profiling():
        out = fn()
    recs = spans.spans()
    spans.reset()
    return out, recs


class WalkingFlat(FlatRouter):
    """The flat probe with its steps not reported as nested: the search
    walks it a pass a step, as it walks the tree router."""

    def nested_steps(self, top_t):
        return None


def _solo(packed, Q, bits, router):
    """Each query searched alone, as a tile of one padded to BQ rows →
    (ids, scores, each row's escalation step: the widest "search.escalate"
    step of its tile, 0 where it took none)."""
    (ids, scores), recs = _escalations(lambda: search_jit_batched(
        packed, Q, bq=1, tile_rows=BQ, filter=bits, escalate="budget", router=router,
        **KW))
    tiles = {s.id: s.counts["tile"] for s in recs if s.name == "search.tile"}
    steps = torch.zeros(Q.shape[0], dtype=torch.int64)
    for s in recs:
        if s.name == "search.escalate":
            i = tiles[s.parent]
            steps[i] = max(int(steps[i]), s.counts["step"])
    return ids, scores, steps


@pytest.mark.parametrize("router", ["flat", "tree"])
@pytest.mark.parametrize("selectivity", [0.1, 0.01, 0.002])
def test_budget_equals_the_reference(packed, routers, data, router, selectivity):
    bits = _bitmap(selectivity)
    ref = _ref(packed, routers, router, selectivity, data[1])
    ids, scores = search_jit_batched(packed, data[1], bq=BQ, filter=bits,
                                     escalate="budget", router=routers[router], **KW)
    same = ids.long() == ref.ids
    assert same.float().mean() >= 0.995
    np.testing.assert_allclose(scores[same].numpy(), ref.scores[same].numpy(), rtol=1e-5)
    got = ids[ids >= 0].long().numpy()
    assert bits[got].all()
    assert ((ids >= 0).sum(1) == (ref.ids >= 0).sum(1)).all()


@pytest.mark.parametrize("router", ["flat", "tree"])
def test_only_thin_rows_take_each_step(packed, routers, data, router):
    """Ragged tiles (bq 64, 200 queries, every tile run at 64 rows).
    Tree: the rows entering step s, summed over tiles, are the reference's
    queries that take s steps or more, and the last tile's 56 pad rows
    never escalate. Flat (the settled path): a tile's one escalation
    settles its thin rows alone, each at the reference's step for that
    row, with one pass a step present; a query alone settles where it
    settles in its tile, and gets the same bits."""
    if router == "flat":
        for sel in (0.015, 0.005):
            _settled_tiles_follow_the_reference(packed, routers, data, sel)
        return
    sel = 0.015
    bits = _bitmap(sel)
    ref = _ref(packed, routers, router, sel, data[1])
    (ids, _), recs = _escalations(lambda: search_jit_batched(
        packed, data[1], bq=BQ, tile_rows=BQ, filter=bits, escalate="budget",
        router=routers[router], **KW))
    assert (ids.long() == ref.ids).float().mean() >= 0.995
    esc = [s for s in recs if s.name == "search.escalate"]
    steps = sorted({s.counts["step"] for s in esc})
    assert steps == list(range(1, int(ref.steps.max()) + 1)) and steps
    for st in steps:
        rows = sum(s.counts["rows"] for s in esc if s.counts["step"] == st)
        assert rows == int((ref.steps >= st).sum())
        kept = sum(s.counts["kept"] for s in esc if s.counts["step"] == st)
        assert kept == int((ref.steps == st).sum())
    tiles = {s.id: s.counts["tile"] for s in recs if s.name == "search.tile"}
    last = [s.counts["rows"] for s in esc if tiles.get(s.parent) == 3]
    assert all(r <= NQ - 3 * BQ for r in last)


def _settled_tiles_follow_the_reference(packed, routers, data, sel):
    bits = _bitmap(sel)
    ref = _ref(packed, routers, "flat", sel, data[1])
    (ids, scores), recs = _escalations(lambda: search_jit_batched(
        packed, data[1], bq=BQ, tile_rows=BQ, filter=bits, escalate="budget",
        router=routers["flat"], **KW))
    assert (ids.long() == ref.ids).float().mean() >= 0.995
    tiles = {s.id: s.counts["tile"] for s in recs if s.name == "search.tile"}
    esc = {tiles[s.parent]: s for s in recs if s.name == "search.escalate"}
    assert len(esc) == sum(1 for s in recs if s.name == "search.escalate")
    for tile in range(len(tiles)):
        st = ref.steps[tile * BQ:(tile + 1) * BQ]
        thin = st[st > 0]
        if not thin.numel():
            assert tile not in esc
            continue
        c = esc[tile].counts
        assert c["rows"] == c["settled"] == c["kept"] == thin.numel()
        assert c["step"] == int(thin.max()) and c["top_t"] == min(TOP_T << c["step"], C)
        assert c["passes"] == len(set(thin.tolist()))
        assert c["probed"] == sum(min(TOP_T << int(s), C) for s in thin)
    alone, alone_s, steps = _solo(packed, data[1], bits, routers["flat"])
    assert torch.equal(steps, ref.steps)
    assert torch.equal(alone, ids) and alone_s.numpy().tobytes() == scores.numpy().tobytes()


def test_a_tile_of_the_whole_batch_gives_the_same_answers(packed, routers, data):
    bits = _bitmap(0.015)
    a, sa = search_jit_batched(packed, data[1], bq=BQ, tile_rows=BQ, filter=bits,
                               escalate="budget", **KW)
    b, sb = search_jit(packed, data[1], filter=bits, escalate="budget", **KW)
    same = a == b
    assert same.float().mean() >= 0.995
    np.testing.assert_allclose(sa[same].numpy(), sb[same].numpy(), rtol=1e-6)


@pytest.mark.parametrize("escalate", [False, True, "budget"])
def test_search_jit_is_one_tile_of_search_jit_batched(packed, data, escalate):
    """`search_jit` is `search_jit_batched` over one tile of every row
    (bq ≥ nq, no tile_rows): the same bits in each escalate mode."""
    kw = dict(filter=_bitmap(0.015), escalate=escalate, **KW)
    a, sa = search_jit(packed, data[1], **kw)
    b, sb = search_jit_batched(packed, data[1], bq=NQ + 1, **kw)
    assert torch.equal(a, b) and sa.numpy().tobytes() == sb.numpy().tobytes()


def test_pad_rows_of_the_batch_never_escalate(packed, data):
    """`queries`: rows past it pad the batch (the engine's bucket rows)."""
    bits = _bitmap(0.002)
    Q = torch.cat([data[1][:5], torch.zeros(3, D)])
    (_, _), recs = _escalations(lambda: search_jit_batched(
        packed, Q, bq=8, tile_rows=8, filter=bits, escalate="budget", queries=5, **KW))
    esc = [s for s in recs if s.name == "search.escalate"]
    assert esc and all(s.counts["rows"] <= 5 for s in esc)
    (tile,) = [s for s in recs if s.name == "search.tile"]
    assert tile.counts["probed"] == 5 * TOP_T


def test_a_population_under_the_budget_stops_once_found(packed, data, index):
    """Twenty eligible ids, all held by the first query's best partition:
    the query finds them all in its first pass and stops there; the
    others walk on until they find them or probe every partition."""
    q0 = data[1][:1]
    p0 = int(torch.argmax(q0 @ index.centroids.T))
    held = packed.part_ids[p0]
    bits = np.zeros(N, np.uint8)
    bits[held[held >= 0][:20].numpy()] = 1
    (ids, _), recs = _escalations(lambda: search_jit(packed, q0, filter=bits,
                                                     escalate="budget", **KW))
    assert not [s for s in recs if s.name == "search.escalate"]
    assert ((ids >= 0).sum() == K) and bits[ids[0].numpy()].all()
    ref = fr.search(_ref_index(packed, None), data[1][:40], torch.from_numpy(bits),
                    top_t=TOP_T, k=K, budget=BUDGET)
    got, _ = search_jit_batched(packed, data[1][:40], bq=BQ, filter=bits,
                                escalate="budget", **KW)
    assert (got.long() == ref.ids).float().mean() >= 0.995
    assert ref.steps[0] == 0 and int(ref.steps.max()) > 0


def test_a_population_under_k_pads_with_minus_one(packed, data):
    bits = _bitmap(0.00025, seed=3)                  # five ids
    ids, scores = search_jit_batched(packed, data[1], bq=BQ, filter=bits,
                                     escalate="budget", **KW)
    assert ((ids >= 0).sum(1) == 5).all()
    assert (ids[:, 5:] == -1).all() and torch.isinf(scores[:, 5:]).all()
    assert set(ids[:, :5].reshape(-1).tolist()) == set(np.nonzero(bits)[0].tolist())


def test_an_all_zero_filter_finds_nothing_and_never_escalates(packed, data):
    (out, recs) = _escalations(lambda: search_jit_batched(
        packed, data[1], bq=BQ, filter=np.zeros(N, np.uint8), escalate="budget", **KW))
    ids, scores = out
    assert (ids == -1).all() and torch.isinf(scores).all()
    assert not [s for s in recs if s.name == "search.escalate"]


@pytest.mark.parametrize("escalate", [True, False, "budget"])
def test_the_unfiltered_path_is_the_same_bits(packed, data, escalate):
    kw = dict(bq=BQ, tile_rows=BQ, **KW)
    ids, scores = search_jit_batched(packed, data[1], **kw)
    got, got_s = search_jit_batched(packed, data[1], escalate=escalate, **kw)
    assert torch.equal(ids, got) and scores.numpy().tobytes() == got_s.numpy().tobytes()


def test_filtered_pack_keeps_the_eligible_slots_alone(packed):
    bits = _bitmap(0.01)
    sub, population = filtered_pack(packed, torch.from_numpy(bits))
    ids, full = sub.part_ids, packed.part_ids
    assert torch.equal(sub.extent, (ids >= 0).sum(1).to(torch.int32))
    for p in range(C):
        row = full[p][full[p] >= 0]
        keep = row[torch.from_numpy(bits)[row.long()] > 0]
        n = int(sub.extent[p])
        assert torch.equal(ids[p, :n], keep) and (ids[p, n:] == -1).all()
        codes = packed.part_codes[p][(full[p] >= 0)][torch.from_numpy(bits)[row.long()] > 0]
        assert torch.equal(sub.part_codes[p, :n], codes)
    assert int(population) == int(bits.sum())


def test_the_counters_add_up(packed, routers, data):
    """`scored` ≤ `gathered`; `scored` is the eligible slots and `gathered`
    the slots of the partitions each query probed: every row's first pass
    at TOP_T, and one pass for each thin row at TOP_T << its reference
    step (the flat route's settled path)."""
    for sel in (0.015, 0.005):
        bits = torch.from_numpy(_bitmap(sel))
        ref = _ref(packed, routers, "flat", sel, data[1])
        _, recs = _escalations(lambda: search_jit_batched(
            packed, data[1], bq=BQ, tile_rows=BQ, filter=bits.numpy(), escalate="budget",
            **KW))
        total = {k: sum(s.counts.get(k, 0) for s in recs)
                 for k in ("probed", "gathered", "scored")}
        elig = ((packed.part_ids >= 0) & (bits[packed.part_ids.clamp(min=0).long()] > 0)).sum(1)
        want = dict(probed=0, gathered=0, scored=0)
        for q, s in zip(data[1], ref.steps.tolist()):
            for t in ([TOP_T, min(TOP_T << s, C)] if s else [TOP_T]):
                parts = torch.topk(q @ packed.centroids.T, t).indices
                want["probed"] += parts.numel()
                want["gathered"] += int(packed.extent[parts].sum())
                want["scored"] += int(elig[parts].sum())
        assert total == want
        assert total["scored"] < total["gathered"]
    assert int(ref.steps.max()) > 1          # 0.005: rows settle past the first step


def test_a_tile_whose_rows_settle_at_two_steps_runs_one_pass_a_step(packed, routers, data):
    """Three rows that settle at step 2 and three at step 3 in one tile:
    one escalation, two passes after the first (each its own stages),
    each row probing its own step's width, and the reference's answers."""
    sel = 0.005
    bits = _bitmap(sel)
    ref = _ref(packed, routers, "flat", sel, data[1])
    two, three = torch.nonzero(ref.steps == 2)[:3, 0], torch.nonzero(ref.steps == 3)[:3, 0]
    assert two.numel() == three.numel() == 3
    pick = torch.cat([three, two])
    (ids, _), recs = _escalations(lambda: search_jit_batched(
        packed, data[1][pick], bq=BQ, tile_rows=BQ, filter=bits, escalate="budget", **KW))
    (esc,) = [s for s in recs if s.name == "search.escalate"]
    c = esc.counts
    assert c["rows"] == c["settled"] == c["kept"] == 6 and c["passes"] == 2
    assert c["step"] == 3 and c["top_t"] == min(TOP_T << 3, C)
    assert c["probed"] == 3 * min(TOP_T << 2, C) + 3 * min(TOP_T << 3, C)
    inner = [s.name for s in recs if s.parent == esc.id]
    assert inner.count("search.route") == 2 and inner.count("search.rerank") == 2
    assert (ids.long() == ref.ids[pick]).float().mean() >= 0.995


@pytest.mark.parametrize("selectivity", [0.015, 0.005, 0.001])
def test_the_settled_path_gives_the_walks_bits(packed, data, index, selectivity):
    """The flat router settled and the same router walked a pass a step:
    the same ids and score bits, each row's pass at the step where the
    walk stopped; the settled tile runs at most one pass a step present,
    the walk one a step it takes."""
    bits = _bitmap(selectivity)
    kw = dict(bq=BQ, tile_rows=BQ, filter=bits, escalate="budget", **KW)
    (a, sa), ra = _escalations(lambda: search_jit_batched(
        packed, data[1], router=FlatRouter(index.centroids), **kw))
    (b, sb), rb = _escalations(lambda: search_jit_batched(
        packed, data[1], router=WalkingFlat(index.centroids), **kw))
    assert torch.equal(a, b) and sa.numpy().tobytes() == sb.numpy().tobytes()
    settled = [s for s in ra if s.name == "search.escalate"]
    walked = [s for s in rb if s.name == "search.escalate"]
    assert sum(s.counts["passes"] for s in settled) <= len(walked)
    assert sum(s.counts["rows"] for s in settled) == sum(
        s.counts["rows"] for s in walked if s.counts["step"] == 1)
    for k in ("probed", "gathered", "scored"):
        assert sum(s.counts.get(k, 0) for s in ra) <= sum(s.counts.get(k, 0) for s in rb)


def test_a_population_under_the_budget_settles_where_the_walk_stopped(packed, data, index):
    """Twenty eligible ids, all in the first query's best partition
    (thresh 20 < the budget): each query alone settles at the step where
    the walk stopped, and at the reference's, with the walk's bits."""
    q0 = data[1][:1]
    p0 = int(torch.argmax(q0 @ index.centroids.T))
    held = packed.part_ids[p0]
    bits = np.zeros(N, np.uint8)
    bits[held[held >= 0][:20].numpy()] = 1
    Q = data[1][:40]
    ids, scores, steps = _solo(packed, Q, bits, FlatRouter(index.centroids))
    w_ids, w_scores, w_steps = _solo(packed, Q, bits, WalkingFlat(index.centroids))
    assert torch.equal(steps, w_steps) and torch.equal(ids, w_ids)
    assert scores.numpy().tobytes() == w_scores.numpy().tobytes()
    ref = fr.search(_ref_index(packed, None), Q, torch.from_numpy(bits), top_t=TOP_T, k=K,
                    budget=BUDGET)
    assert torch.equal(steps, ref.steps) and len(set(steps.tolist())) > 1
    assert ((ids >= 0).sum(1) == K).all()


def test_the_flat_router_says_its_steps_nest(routers, data):
    """Flat: the widths of its steps, each route the widest's cut; tree:
    None, its steps widen the reachable set."""
    flat = routers["flat"]
    assert flat.nested_steps(TOP_T) == [16, 32, 64] and flat.nested_steps(C) == []
    assert flat.nested_steps(40) == [64] and flat.nested_steps(0) == []
    v, p = flat.route(data[1], C)
    for w in (TOP_T, 16, 32):
        vw, pw = flat.route(data[1], w)
        assert torch.equal(pw, p[:, :w]) and vw.numpy().tobytes() == v[:, :w].numpy().tobytes()
    assert routers["tree"].nested_steps(TOP_T) is None


def test_an_id_held_more_often_than_assumed_takes_the_last_step(packed, routers, data):
    """`settle_steps` at multiplicity 1 over a spilled index (an id may
    hold two slots): the prefix it counts can stop short, and a row whose
    count does not reach the bar there is not settled and takes the last
    step; a row settled at both multiplicities settles at the same step."""
    bits = torch.from_numpy(_bitmap(0.005))
    sub = _subset(packed, bits, K, BUDGET)
    parts = routers["flat"].route(data[1], C)[1]
    widths = routers["flat"].nested_steps(TOP_T)
    steps2, settled2 = settle_steps(sub, parts, widths, 2)
    steps1, settled1 = settle_steps(sub, parts, widths, 1)
    ref = _ref(packed, routers, "flat", 0.005, data[1])
    assert settled2.all() and torch.equal(steps2, ref.steps)
    assert (~settled1).any() and (steps1[~settled1] == len(widths)).all()
    assert torch.equal(steps1[settled1], steps2[settled1])


def test_search_params_take_the_budget_mode():
    assert "budget" in ESCALATE_MODES and ESCALATE_BUDGET == "budget"
    p = SearchParams(escalate="budget").validate(default_top_t=8, default_rerank=64)
    assert p.escalate == "budget"
    assert SearchParams(escalate=np.bool_(True)).validate().escalate is True
    for bad in ("Budget", "yes", 1, None):
        with pytest.raises(ValueError, match="escalate"):
            SearchParams(escalate=bad).validate()
    keys = {SearchParams(tenant="a", escalate=e).validate().batch_key()
            for e in (True, False, "budget")}
    assert len(keys) == 3


@pytest.fixture(scope="module")
def engine(data):
    idx = MutableIVF.build(torch.Generator().manual_seed(0), data[0], C, spill_mode="soar",
                           lam=1.0, pq_subspaces=M, device="cpu")
    return AnnEngine(idx, top_t=TOP_T, rerank_budget=BUDGET, bq=BQ)


def test_the_engine_serves_the_budget_mode(engine, data):
    bits = _bitmap(0.002)
    Qn = data[1][:37].numpy()
    r = engine.search_request(Qn, SearchParams(k=K, filter_mask=bits, escalate="budget"))
    assert r.escalated and r.ids.shape == (37, K)
    ids, scores = search_jit_batched(engine.index.pack(), Qn, bq=64, tile_rows=BQ,
                                     filter=engine.index.filter_bitmap(mask=bits),
                                     escalate="budget", multiplicity=2, **KW)
    assert np.array_equal(r.ids, ids.numpy()) and np.array_equal(r.scores, scores.numpy())
    assert bits[r.ids[r.ids >= 0]].all()
    old = engine.search_request(Qn, SearchParams(k=K, filter_mask=bits, escalate=True))
    assert ((r.ids >= 0).sum(1) >= (old.ids >= 0).sum(1)).all()


def test_the_standing_filter_keeps_the_budget_mode(data):
    idx = MutableIVF.build(torch.Generator().manual_seed(0), data[0][:4000], 16,
                           spill_mode="soar", lam=1.0, pq_subspaces=M, device="cpu")
    idx.remove(np.arange(0, 3000), hard=False)
    assert idx.serving_filter(escalate="budget")[1] == "budget"
    idx2 = MutableIVF.build(torch.Generator().manual_seed(0), data[0][:4000], 16,
                            spill_mode="soar", lam=1.0, pq_subspaces=M, device="cpu")
    idx2.remove(np.arange(0, 10), hard=False)
    assert idx2.serving_filter(escalate="budget")[1] is False


def test_the_tenant_seam_escalates_by_the_budget(engine, data):
    """A tenant's device bitmap through the front-end's `_filter_dev` seam
    gives the bits of the same subset given as filter_ids."""
    keep = np.arange(0, N, 400)
    bm = engine.index.filter_bitmap(ids=keep)
    Qn = data[1][:20].numpy()
    a = engine.search_request(Qn, SearchParams(k=K, escalate="budget"), _filter_dev=bm)
    b = engine.search_request(Qn, SearchParams(k=K, escalate="budget", filter_ids=keep))
    assert np.array_equal(a.ids, b.ids) and np.array_equal(a.scores, b.scores)
    assert (a.ids[a.ids >= 0] % 400 == 0).all()
    fe = ServingFrontend(engine, max_batch=64, policy="local")
    try:
        fe.register_tenant("t", ids=keep)
        got = fe.submit(Qn, SearchParams(k=K, escalate="budget", tenant="t")).result(timeout=60)
        assert np.array_equal(got.ids, a.ids)
    finally:
        fe.close()
