"""The port's serving slice (repro_torch) against the JAX package: the
mutable index, the host engine, the pruned tree router, the request API
and AnnEngine.

A JAX `MutableIVF` is carried across with `convert.mutable_from_numpy`,
then both take the same mutation script, and their state is equal bit for
bit after every step. Inside the port, a mutated index searches as a
from-scratch rebuild of its live rows on both engines, and the delta pack
equals a full repack. Runs on the CPU at n <= 8,000, d = 24, c = 32,
m = 8, inputs made by numpy from a seed; tests/test_torch_cuda.py repeats
the kernels' new inputs on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import search as jax_search  # noqa: E402
from repro.core.mutable import MutableIVF as JaxMutableIVF  # noqa: E402
from repro.core.router import train_tree_router as jax_train_tree_router  # noqa: E402
from repro.serve import api as jax_api  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import pack_ivf, search_jit, search_numpy  # noqa: E402
from repro_torch.core.mutable import MutableIVF  # noqa: E402
from repro_torch.core.router import TreeRouter  # noqa: E402
from repro_torch.serve import api  # noqa: E402
from repro_torch.serve.engine import AnnEngine  # noqa: E402

N, D, NQ, C, M = 8000, 24, 32, 32, 8
KW = dict(top_t=8, final_k=10, rerank_budget=128)
STATE = ("part_ids", "part_codes", "sizes", "assignments", "alive")
COUNTS = ("n_total", "n_dead_slots", "n_soft_deleted")


def manifold(seed, n, d, nq, p=6, hidden=64):
    """Unit vectors on a p-dimensional manifold (a random two-layer map),
    made by numpy: (X (n, d), Q (nq, d)) f32."""
    rng = np.random.default_rng(seed)
    W1 = rng.standard_normal((p, hidden))
    W2 = rng.standard_normal((hidden, d)) / np.sqrt(hidden)
    Y = np.tanh(2.0 * rng.standard_normal((n + nq, p)) @ W1 / np.sqrt(p)) @ W2
    Y = (Y / np.linalg.norm(Y, axis=1, keepdims=True)).astype(np.float32)
    return Y[:n], Y[n:]


def mutable_fields(m):
    """A JAX MutableIVF's state as convert.mutable_from_numpy's fields."""
    f = {k: getattr(m, k) for k in STATE + COUNTS + (
        "centroids", "rerank", "spill_mode", "lam", "n_spills", "compact_threshold")}
    f["pq.centers"] = None if m.pq is None else np.asarray(m.pq.centers)
    if m.router is not None:
        rt = m.router
        f.update({"router": {"type": "tree", "t_route": rt.t_route,
                             "n_partitions": rt.n_partitions},
                  "router.super_centroids": np.asarray(rt.super_centroids),
                  "router.children": np.asarray(rt.children),
                  "router.child_centroids": np.asarray(rt.child_centroids)})
    return f


def assert_same_state(jm, tm, step):
    for k in STATE:
        want, got = getattr(jm, k), getattr(tm, k)
        if want is None:
            assert got is None, (step, k)
            continue
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{step}: {k}")
    for k in COUNTS:
        assert getattr(tm, k) == getattr(jm, k), (step, k)


def _agree(a, b):
    return float((np.asarray(a) == np.asarray(b)).mean())


def _mapped(ids, id_map):
    ids = np.asarray(ids)
    return np.where(ids >= 0, id_map[np.maximum(ids, 0)], -1)


@pytest.fixture(scope="module")
def data():
    return manifold(0, N, D, NQ)


@pytest.fixture(scope="module")
def jax_base(data):
    """The JAX package's mutable index over the first 6,000 rows."""
    return JaxMutableIVF.build(jax.random.PRNGKey(1), data[0][:6000], C,
                               spill_mode="soar", pq_subspaces=M, train_iters=5)


@pytest.fixture(scope="module")
def scripted(data, jax_base):
    """Both packages through the same mutation script from the same bits,
    the states compared after every step → (jax index, port index,
    hard-removed ids, soft-removed ids)."""
    X = data[0]
    jm = JaxMutableIVF.from_index(jax_base.to_ivf_index())
    tm = convert.mutable_from_numpy(mutable_fields(jm), device="cpu")
    assert_same_state(jm, tm, "carried")
    rng = np.random.default_rng(0)
    new = jm.add(X[6000:])
    np.testing.assert_array_equal(tm.add(X[6000:]).numpy(), new)
    assert_same_state(jm, tm, "add")
    hard = np.concatenate([rng.choice(6000, 500, replace=False),
                           rng.choice(new, 200, replace=False)])
    assert tm.remove(hard) == jm.remove(hard) == 700
    assert_same_state(jm, tm, "hard remove")
    soft = rng.choice(N, 300, replace=False)
    assert tm.remove(torch.from_numpy(soft), hard=False) == jm.remove(soft, hard=False)
    assert_same_state(jm, tm, "soft remove")
    assert tm.harden_soft_deletes() == jm.harden_soft_deletes() > 0
    assert_same_state(jm, tm, "harden")
    jm.compact()
    tm.compact()
    assert_same_state(jm, tm, "compact")
    more = rng.choice(N, 2500, replace=False)
    assert tm.remove(more) == jm.remove(more)
    assert jm.n_dead_slots == 0                 # crossed the threshold: compacted
    assert_same_state(jm, tm, "threshold compaction")
    return jm, tm, np.concatenate([hard, more]), soft


# ------------------------------------------------------------ mutable state
def test_mutation_script_state_matches_jax_bit_for_bit(scripted):
    jm, tm, _, _ = scripted
    assert tm.n_alive == jm.n_alive and tm.n_slots == jm.n_slots


def test_capacity_growth_matches_jax(data):
    """Adding far more points than the slack grows the partition rows and
    the rerank rows alike in both packages (tests/test_mutable.py:107)."""
    X = data[0]
    jm = JaxMutableIVF.build(jax.random.PRNGKey(3), X[:1000], 8,
                             spill_mode="soar", pq_subspaces=M, train_iters=3)
    tm = convert.mutable_from_numpy(mutable_fields(jm), device="cpu")
    cap0 = tm.part_ids.shape[1]
    for lo, hi in ((1000, 1100), (1100, 5000)):
        np.testing.assert_array_equal(tm.add(X[lo:hi]).numpy(), jm.add(X[lo:hi]))
        assert_same_state(jm, tm, f"add {lo}:{hi}")
    assert tm.part_ids.shape[1] > cap0 and tm.n_alive == 5000
    counts = np.bincount(tm.to_ivf_index().point_ids.numpy(), minlength=5000)
    assert np.all(counts == 2)


def test_remove_all_then_repopulate_matches_jax(data):
    """Fully tombstoned, both engines return -1 rows; re-adding serves fresh
    stable ids (tests/test_mutable.py:131)."""
    X, Q = data
    jm = JaxMutableIVF.build(jax.random.PRNGKey(6), X[:1000], 8,
                             pq_subspaces=M, train_iters=2)
    tm = convert.mutable_from_numpy(mutable_fields(jm), device="cpu")
    assert tm.remove(np.arange(1000)) == jm.remove(np.arange(1000))
    assert_same_state(jm, tm, "remove all")
    ids, _ = search_jit(tm.pack(), Q[:4], top_t=4, final_k=5, rerank_budget=16)
    assert ids.shape == (4, 5) and (ids == -1).all()
    ids_np, _ = search_numpy(tm.to_ivf_index(), Q[:4], top_t=4, final_k=5)
    assert (ids_np == -1).all()
    new = tm.add(X[:50])
    np.testing.assert_array_equal(new.numpy(), jm.add(X[:50]))
    assert_same_state(jm, tm, "repopulate")
    assert int(new[0]) == 1000
    ids2, _ = search_jit(tm.pack(), X[:8], top_t=6, final_k=3, rerank_budget=32)
    np.testing.assert_array_equal(ids2[:, 0].numpy(), new[:8].numpy())


def test_remove_is_idempotent_and_bounded(data):
    tm = convert.mutable_from_numpy(mutable_fields(JaxMutableIVF.build(
        jax.random.PRNGKey(4), data[0][:1000], 8, train_iters=3)), device="cpu")
    assert tm.remove([5, 5, 5]) == 1
    assert tm.remove([5]) == 0
    assert tm.remove([10 ** 6, -3]) == 0
    assert tm.n_alive == 999


# ------------------------------------------------------------ search parity
def test_search_matches_both_jax_engines(scripted, data):
    jm, tm, _, _ = scripted
    Q = data[1]
    wi, wv = jax_search.search_jit(jm.pack(pair_codes=False), jnp.asarray(Q), **KW)
    gi, gv = search_jit(tm.pack(), Q, **KW)
    assert _agree(gi.numpy(), wi) >= 0.995
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5, atol=1e-5)
    ni, nstats = jax_search.search_numpy(jm.to_ivf_index(), Q, **KW)
    hi, hstats = search_numpy(tm.to_ivf_index(), Q, **KW)
    assert hi.dtype == torch.int32 and hi.shape == (NQ, KW["final_k"])
    assert _agree(hi.numpy(), ni) >= 0.995
    np.testing.assert_array_equal(hstats.points_read.numpy(), nstats.points_read)
    np.testing.assert_array_equal(hstats.unique_candidates.numpy(),
                                  nstats.unique_candidates)


@pytest.mark.parametrize("rerank_budget", [0, 64])
@pytest.mark.parametrize("mask_len", [N - 1500, N + 700])
def test_host_engine_filtered_matches_jax(scripted, data, rerank_budget, mask_len):
    """A filter shorter than n_points zero-pads and a longer one is cut, as
    in the JAX host engine (search_jit's length is strict); thin windows
    escalate through the host loop."""
    jm, tm, _, _ = scripted
    Q = data[1]
    mask = (np.random.default_rng(mask_len).uniform(size=mask_len) < 0.02).astype(np.uint8)
    kw = dict(top_t=4, final_k=10, rerank_budget=rerank_budget, filter_mask=mask)
    want, wstats = jax_search.search_numpy(jm.to_ivf_index(), Q, **kw)
    got, gstats = search_numpy(tm.to_ivf_index(), Q, **kw)
    assert _agree(got.numpy(), want) >= 0.995
    np.testing.assert_array_equal(gstats.unique_candidates.numpy(),
                                  wstats.unique_candidates)
    g = got.numpy()
    g = g[g >= 0]
    assert (g < mask_len).all() and mask[g].all()


def test_host_engine_chunks_change_nothing(scripted, data, monkeypatch):
    """Walking the queries in chunks of a few candidates gives the same ids
    and stats as one chunk."""
    from repro_torch.core import search as search_mod
    _, tm, _, _ = scripted
    idx = tm.to_ivf_index()
    whole, ws = search_numpy(idx, data[1], **KW)
    monkeypatch.setattr(search_mod, "CAND_CHUNK", 500)
    parts, ps = search_numpy(idx, data[1], **KW)
    assert torch.equal(parts, whole)
    assert torch.equal(ps.unique_candidates, ws.unique_candidates)


@pytest.fixture(scope="module")
def rebuilt(scripted):
    _, tm, _, _ = scripted
    scratch = tm.rebuild_reference()
    live = np.flatnonzero(tm.alive[:tm.n_total].numpy())
    id_map = np.full(tm.n_total, -1, np.int64)
    id_map[live] = np.arange(live.size)
    return scratch, id_map


def test_mutated_equals_rebuilt_on_both_engines(scripted, rebuilt, data):
    """tests/test_mutable.py:53,63 inside the port: identical ids."""
    _, tm, _, _ = scripted
    scratch, id_map = rebuilt
    Q = data[1]
    mi, mv = search_jit(tm.pack(), Q, **KW)
    si, sv = search_jit(pack_ivf(scratch), Q, **KW)
    np.testing.assert_array_equal(_mapped(mi.numpy(), id_map), si.numpy())
    np.testing.assert_allclose(mv.numpy(), sv.numpy(), rtol=1e-5, atol=1e-5)
    hi, _ = search_numpy(tm.to_ivf_index(), Q, **KW)
    hs, _ = search_numpy(scratch, Q, **KW)
    np.testing.assert_array_equal(_mapped(hi.numpy(), id_map), hs.numpy())


def test_removed_ids_never_returned(scripted, data):
    _, tm, hard, soft = scripted
    dead = np.concatenate([hard, soft])
    ids, _ = search_jit(tm.pack(), data[1], top_t=16, final_k=20, rerank_budget=256)
    assert not np.isin(ids.numpy(), dead).any()
    ids_np, _ = search_numpy(tm.to_ivf_index(), data[1], top_t=16, final_k=20)
    assert not np.isin(ids_np.numpy(), dead).any()


# --------------------------------------------------------------- delta pack
def test_delta_pack_identical_to_full_repack(data):
    """tests/test_build_perf.py:257 inside the port. The snapshot's ids,
    codes and rerank rows are the index's own tensors (a view); what the
    delta computes (sizes, extent and the pruned router, with one
    partition emptied) equals a full repack's."""
    X = data[0]
    tm = MutableIVF.build(torch.Generator().manual_seed(21), X[:4000], 16,
                          spill_mode="soar", pq_subspaces=M, train_iters=3,
                          router="tree", device="cpu")
    tm.add(X[4000:4900])                 # grows the rows: a full repack
    tm.pack()
    tm.add(X[4900:4950])
    row = tm.part_ids[5]
    tm.remove(np.concatenate([np.arange(100, 300), row[row >= 0].numpy()]))
    assert tm._dirty_parts is not None and tm._dirty_parts.any()   # no compaction
    delta = tm.pack()
    assert tm._dirty_parts is not None and not tm._dirty_parts.any()
    for a, b in ((delta.part_ids, tm.part_ids), (delta.part_codes, tm.part_codes),
                 (delta.rerank, tm.rerank)):
        assert a.data_ptr() == b.data_ptr()
    assert delta.router is not tm.router and (delta.router.children != 5).all()
    tm.invalidate_snapshots()
    full = tm.pack()
    assert full is not delta and full.router is not delta.router
    for a, b in ((delta.sizes, full.sizes), (delta.extent, full.extent),
                 (delta.router.children, full.router.children)):
        assert torch.equal(a, b)


def test_delta_pack_search_matches_after_mutation_burst(data):
    """tests/test_build_perf.py:279 inside the port: interleaved add,
    remove, pack and search equal a full repack at every step."""
    X, Q = data
    tm = MutableIVF.build(torch.Generator().manual_seed(22), X[:3000], 16,
                          spill_mode="soar", pq_subspaces=M, train_iters=3,
                          device="cpu")
    kw = dict(top_t=6, final_k=5, rerank_budget=64)
    for step in range(4):
        lo = 3000 + step * 200
        new = tm.add(X[lo:lo + 200])
        tm.remove(new[::3])
        di, dv = search_jit(tm.pack(), Q[:8], **kw)
        tm.invalidate_snapshots()
        fi, fv = search_jit(tm.pack(), Q[:8], **kw)
        assert torch.equal(di, fi) and torch.equal(dv, fv)


def test_filter_width_kept_across_rerank_growth(data):
    """`alive` and `rerank` grow together, so the standing filter keeps the
    width the search's filter check asks for (the rerank capacity)."""
    X, Q = data
    tm = MutableIVF.build(torch.Generator().manual_seed(5), X[:1000], 8,
                          pq_subspaces=M, train_iters=3, device="cpu")
    tm.remove(np.arange(0, 1000, 2), hard=False)
    for lo, hi in ((1000, 1010), (1010, 3000)):
        tm.add(X[lo:hi])
        packed = tm.pack()
        assert tm.alive.shape[0] == tm.rerank.shape[0] == packed.rerank.shape[0]
        filt, _ = tm.serving_filter()
        assert filt.shape == (packed.rerank.shape[0],)
        ids, _ = search_jit(packed, Q, filter=filt, **KW)
        got = ids.numpy()
        assert tm.alive[got[got >= 0]].all()
    assert tm.rerank.shape[0] > 1000


# ------------------------------------------------------------ pruned router
def test_pruned_tree_router_matches_jax(data):
    """Children of dead partitions become -1, inside a row and across every
    child of one super; the route then matches JAX's pruned router and
    never reaches a dead partition."""
    X, Q = data
    cents = X[np.random.default_rng(7).choice(N, 64, replace=False)]
    jr = jax_train_tree_router(jax.random.PRNGKey(3), cents, n_super=8, t_route=3)
    tr = TreeRouter(*(torch.from_numpy(np.array(a)) for a in
                      (jr.super_centroids, jr.children, jr.child_centroids)),
                    jr.t_route, jr.n_partitions)
    assert tr.pruned(np.ones(64, bool)) is tr
    ch = np.asarray(jr.children)
    live = np.random.default_rng(8).uniform(size=64) < 0.7
    live[ch[0][ch[0] >= 0]] = False                  # super 0 keeps no child
    want, got = jr.pruned(live), tr.pruned(torch.from_numpy(live))
    np.testing.assert_array_equal(got.children.numpy(), np.asarray(want.children))
    assert (got.children[0] == -1).all()
    assert torch.equal(tr.children, torch.from_numpy(ch))   # tables untouched
    for top_t in (4, 12):
        ws, wp = want.route(jnp.asarray(Q), top_t)
        gs, gp = got.route(torch.from_numpy(Q), top_t)
        fin = np.isfinite(np.asarray(ws))
        np.testing.assert_array_equal(np.isfinite(gs.numpy()), fin)
        np.testing.assert_array_equal(gp.numpy()[fin], np.asarray(wp)[fin])
        assert live[gp.numpy()[fin]].all()


def test_serving_router_prunes_emptied_partitions(data):
    """A partition emptied by removal drops out of the snapshot's router
    and comes back when an add repopulates it."""
    X = data[0]
    tm = MutableIVF.build(torch.Generator().manual_seed(9), X[:2000], 16,
                          pq_subspaces=M, train_iters=3, router="tree",
                          device="cpu")
    assert tm.pack().router is tm.router
    victims = tm.to_ivf_index().point_ids[tm.to_ivf_index().starts[3]:
                                          tm.to_ivf_index().starts[4]]
    gone = torch.unique(victims).numpy()
    tm.remove(gone)
    rt = tm.pack().router
    part3 = (tm.router.children == 3)
    assert (tm.part_ids[3] < 0).all() and part3.any()
    assert (rt.children[part3] == -1).all() and rt is not tm.router
    tm.add(X[gone])
    assert tm.pack().router.children.eq(3).any()


# --------------------------------------------------------- the request API
@pytest.mark.parametrize("kw", [
    {}, {"k": 0}, {"k": True}, {"k": 3.0}, {"top_t": 0}, {"top_t": 5},
    {"rerank_budget": -1}, {"rerank_budget": np.int64(7)},
    {"deadline_ms": 0}, {"deadline_ms": float("nan")}, {"deadline_ms": 0.01},
    {"deadline_ms": 1e9}, {"deadline_ms": True}, {"deadline_ms": 20},
    {"recency": -1}, {"recency": 3}, {"recency": True},
    {"filter_ids": [1, 2]}, {"segment": 2}, {"tenant": "t"}])
def test_search_params_validate_and_batch_key_match_jax(kw):
    def outcome(mod):
        try:
            v = mod.SearchParams(**kw).validate(default_top_t=8, default_rerank=64)
        except ValueError:
            return "raises"
        return (v.k, v.top_t, v.rerank_budget, v.deadline_ms, v.recency,
                v.has_inline_filter, v.batch_key())
    assert outcome(api) == outcome(jax_api)


@pytest.mark.parametrize("case", [
    "ok", "vector", "int", "object", "complex", "string", "rank3", "wrong_dim",
    "nan", "nan_sanitized", "overflow", "overflow_sanitized", "empty"])
def test_validate_queries_matches_jax(case):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((3, D)).astype(np.float32)
    sanitize = case.endswith("_sanitized")
    Q = {"ok": q, "vector": q[0], "int": np.arange(2 * D).reshape(2, D),
         "object": q.astype(object), "complex": q.astype(np.complex64),
         "string": np.array([["a"] * D]), "rank3": q[None], "wrong_dim": q[:, :-1],
         "nan": np.where(np.eye(3, D) > 0, np.nan, q),
         "nan_sanitized": np.where(np.eye(3, D) > 0, np.nan, q),
         "overflow": np.full((2, D), 1e300), "overflow_sanitized": np.full((2, D), 1e300),
         "empty": np.empty((0, D), np.float32)}[case]

    def outcome(mod):
        try:
            return mod.validate_queries(Q, D, sanitize=sanitize)
        except ValueError as e:
            return str(e)
    want, got = outcome(jax_api), outcome(api)
    if isinstance(want, str):
        assert got == want
    else:
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_error_taxonomy_matches_jax():
    for name in ("ServingError", "OverloadedError", "DeadlineExceededError",
                 "FrontendClosedError"):
        e = getattr(api, name)("x", queued_us=3, engine_us=4)
        assert e.retryable == getattr(jax_api, name).retryable
        assert (e.queued_us, e.engine_us) == (3.0, 4.0)
        assert api.is_retryable(e) == jax_api.is_retryable(e)
    for exc in (TimeoutError(), ValueError(), ConnectionError()):
        assert api.is_retryable(exc) == jax_api.is_retryable(exc)


# ------------------------------------------------------------------ engine
@pytest.fixture(scope="module")
def engine(data):
    return AnnEngine.build(torch.Generator().manual_seed(1), data[0][:3000], 16,
                           spill_mode="soar", pq_subspaces=M, train_iters=5,
                           device="cpu")


def test_engine_shim_parity(engine, data):
    """search(kwargs) ≡ search_request(SearchParams), unfiltered and
    filtered (tests/test_serve_api.py:56)."""
    Q = data[1]
    ids_a, sc_a = engine.search(Q, k=7, top_t=6, escalate=False)
    r = engine.search_request(Q, api.SearchParams(k=7, top_t=6, escalate=False))
    assert isinstance(ids_a, np.ndarray) and ids_a.dtype == np.int32
    np.testing.assert_array_equal(ids_a, r.ids)
    np.testing.assert_array_equal(sc_a, r.scores)
    ids_b, sc_b = r
    assert ids_b is r.ids and sc_b is r.scores
    assert r.batch_size == NQ and r.epoch == engine.index._alive_epoch
    mask = np.zeros(3000, np.uint8)
    mask[:1000] = 1
    ids_f, sc_f = engine.search(Q, k=5, filter_mask=mask)
    rf = engine.search_request(Q, api.SearchParams(k=5, filter_mask=mask))
    np.testing.assert_array_equal(ids_f, rf.ids)
    np.testing.assert_array_equal(sc_f, rf.scores)
    assert (rf.ids < 1000).all() and rf.escalated


def test_engine_validation_and_metadata(engine, data):
    """Bad arguments raise through the engine edge; a request's metadata
    (tests/test_serve_api.py:237)."""
    q = data[1][:2]
    for kw in ({"k": 0}, {"top_t": 0}, {"k": True}):
        with pytest.raises(ValueError):
            engine.search(q, **kw)
    bad = q.copy()
    bad[0, 0] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        engine.search(bad, k=3)
    fixed = bad.copy()
    fixed[0, 0] = 0.0
    r = engine.search_request(bad, api.SearchParams(k=3, sanitize=True))
    np.testing.assert_array_equal(r.ids, engine.search(fixed, k=3)[0])
    r = engine.search_request(data[1][:3], api.SearchParams(k=4, deadline_ms=1000.0))
    assert r.nq == 3 and r.k == 4 and r.engine_us > 0 and r.queued_us == 0.0
    # the deadline is judged on the request's own engine time, which a
    # loaded machine may stretch past the 1-s budget
    assert r.deadline_met() is (r.engine_us <= 1000.0 * 1e3) and r.total_us == r.engine_us
    r0 = engine.search_request(np.empty((0, D), np.float32))
    assert r0.nq == 0 and r0.ids.shape == (0, 10)
    with pytest.raises(ValueError):
        AnnEngine(engine.index, bq=0)


def test_engine_roundtrip(data):
    """Build, search, add, find the added points, remove them, never see
    them again (tests/test_mutable.py:166); soft removal too."""
    X = data[0]
    eng = AnnEngine.build(torch.Generator().manual_seed(5), X[:3000], 16,
                          pq_subspaces=M, train_iters=3, top_t=8, device="cpu")
    ids0, _ = eng.search(data[1], k=5)
    assert ids0.shape == (NQ, 5) and (ids0 >= 0).all()
    new = eng.add(X[3000:3100])
    assert isinstance(new, np.ndarray) and eng.n_alive == 3100
    ids1, _ = eng.search(X[3000:3100], k=3)
    assert (ids1[:, 0] == new).mean() > 0.9
    assert eng.remove(new) == 100
    ids2, _ = eng.search(X[3000:3100], k=3)
    assert not np.isin(ids2, new).any()
    soft = np.arange(0, 3000, 3)
    assert eng.remove(soft, hard=False) == soft.size
    ids3, _ = eng.search(X[:300], k=5)
    assert not np.isin(ids3, soft).any()
