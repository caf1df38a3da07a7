"""The port's serving front-end (repro_torch.serve.frontend and .health,
core.distributed.make_replicated_search) against the JAX package, on the
CPU.

A JAX `MutableIVF` built by `repro.serve.engine.AnnEngine.build` is
carried across with `convert.mutable_from_numpy`; each test serves a fresh
copy. Against JAX: the same requests through both front-ends give the same
ids on >= 0.995 of slots (the engine bar of
test_torch_serve.py::test_search_matches_both_jax_engines), tenant bitmaps
equal JAX's bit for bit, and both circuit breakers walk the same states.
Inside the port: tests/test_frontend.py and tests/test_resilience.py case
for case (the replica cases through two CPU replicas, the front-end's
`replica_devices` monkeypatched; the shard-parallel degraded fan-out is
in tests/test_torch_distributed.py), the padding repair
(coalesced ≡ solo bit for bit) and a barrier stress test. n = 3,000,
d = 24, inputs made by numpy from a seed. Every Future, flush and join
takes a timeout, and every front-end is closed by a fixture finalizer.
"""
import asyncio
import sys
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import faults as jax_faults  # noqa: E402
from repro.core.mutable import MutableIVF as JaxMutableIVF  # noqa: E402
from repro.serve import health as jax_health  # noqa: E402
from repro.serve.api import SearchParams as JaxSearchParams  # noqa: E402
from repro.serve.engine import AnnEngine as JaxAnnEngine  # noqa: E402
from repro.serve.frontend import ServingFrontend as JaxServingFrontend  # noqa: E402
from repro.serve.frontend import TenantFilterBank as JaxTenantFilterBank  # noqa: E402

from repro_torch import convert, faults  # noqa: E402
from repro_torch.core import search as search_mod  # noqa: E402
from repro_torch.core.distributed import make_replicated_search  # noqa: E402
from repro_torch.core.router import FlatRouter  # noqa: E402
from repro_torch.core.search import pad_queries, search_jit_batched  # noqa: E402
from repro_torch.faults import (FaultPlan, InjectedCrash, InjectedFault,  # noqa: E402
                                InjectedTransientFault)
from repro_torch.serve import engine as engine_mod  # noqa: E402
from repro_torch.serve import frontend  # noqa: E402
from repro_torch.serve.api import (DeadlineExceededError,  # noqa: E402
                                   FrontendClosedError, OverloadedError,
                                   SearchParams, ServingError, is_retryable)
from repro_torch.serve.engine import AnnEngine  # noqa: E402
from repro_torch.serve.frontend import (ServingFrontend,  # noqa: E402
                                        TenantFilterBank, UnknownTenantError,
                                        _Request)
from repro_torch.serve.health import (CLOSED, HALF_OPEN, OPEN,  # noqa: E402
                                      CircuitBreaker, HealthTracker,
                                      shards_ok_from_mask)

N, D, NQ, C = 3_000, 24, 32, 16
T_OUT = 60.0          # seconds any Future, flush or join may take here
STATE = ("part_ids", "part_codes", "sizes", "rerank", "assignments", "alive")
COUNTS = ("n_total", "n_dead_slots", "n_soft_deleted")
CPU2 = [torch.device("cpu"), torch.device("cpu")]


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.uninstall()
    jax_faults.uninstall()
    yield
    faults.uninstall()
    jax_faults.uninstall()


def manifold(seed, n, d, nq, p=8, hidden=64):
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
        "centroids", "spill_mode", "lam", "n_spills", "compact_threshold")}
    f["pq.centers"] = None if m.pq is None else np.asarray(m.pq.centers)
    return f


@pytest.fixture(scope="module")
def ds():
    X, Q = manifold(0, N, D, NQ)
    return type("DS", (), {"X": X, "Q": Q})


@pytest.fixture(scope="module")
def jax_base(ds):
    return JaxAnnEngine.build(jax.random.PRNGKey(1), ds.X, C,
                              spill_mode="soar", train_iters=5).index


def jax_twin(jax_base):
    return JaxAnnEngine(JaxMutableIVF.from_index(jax_base.to_ivf_index()))


def port_twin(jeng):
    return AnnEngine(convert.mutable_from_numpy(mutable_fields(jeng.index), device="cpu"))


@pytest.fixture()
def engine(jax_base):
    """A fresh port engine over the JAX build's state."""
    return port_twin(jax_twin(jax_base))


@pytest.fixture()
def make_fe():
    """ServingFrontend factory; every front-end made is closed at teardown."""
    made = []

    def make(eng, cls=ServingFrontend, **kw):
        fe = cls(eng, **kw)
        made.append(fe)
        return fe

    yield make
    for fe in made:
        fe.close(drain=False)
        assert not fe._thread.is_alive()


def _agree(a, b):
    return float((np.asarray(a) == np.asarray(b)).mean())


# ----------------------------------------------------------- against JAX
def test_frontend_matches_jax_frontend(ds, jax_base, make_fe):
    """The same requests (plain, tenant, inline filter, after a tenant add
    and a removal) through both front-ends: ids on >= 0.995 of slots,
    scores within 1e-5 where the ids agree, epochs equal."""
    jeng = jax_twin(jax_base)
    teng = port_twin(jeng)
    rng = np.random.default_rng(3)
    new = rng.normal(size=(6, D)).astype(np.float32)
    mask = (np.arange(N) % 4 == 1).astype(np.uint8)
    got = {}
    for name, eng, cls, P in (("jax", jeng, JaxServingFrontend, JaxSearchParams),
                              ("port", teng, ServingFrontend, SearchParams)):
        fe = make_fe(eng, cls=cls, policy="local", default_deadline_ms=100.0)
        fe.register_tenant("t", ids=np.arange(0, N, 3))
        futs = [fe.submit(ds.Q[i:i + 1], P(k=6)) for i in range(8)]
        futs += [fe.submit(ds.Q[8:16], P(k=5, tenant="t")),
                 fe.submit(ds.Q[16:20], P(k=4, filter_mask=mask))]
        out = [f.result(timeout=T_OUT) for f in futs]
        ids_new = fe.add(new, tenant="t")
        out.append(fe.search(new, P(k=3, tenant="t")))
        fe.remove(np.arange(0, 300))
        out.append(fe.search(ds.Q, P(k=6)))
        fe.close()
        got[name] = (out, ids_new)
    (jo, jnew), (to, tnew) = got["jax"], got["port"]
    np.testing.assert_array_equal(tnew, jnew)
    for a, b in zip(jo, to):
        assert _agree(a.ids, b.ids) >= 0.995
        same = a.ids == b.ids
        np.testing.assert_allclose(b.scores[same], a.scores[same], rtol=1e-5, atol=1e-5)
        assert a.epoch == b.epoch and a.tenant == b.tenant


def test_tenant_bitmaps_equal_jax(jax_base):
    """TenantFilterBank.get: the port's device bitmap equals JAX's bit for
    bit after registration, a soft removal (epoch bump), an extend and an
    add that grows the capacity; fills count alike."""
    jeng = jax_twin(jax_base)
    teng = port_twin(jeng)
    jb, tb = JaxTenantFilterBank(jeng.index), TenantFilterBank(teng.index)
    rng = np.random.default_rng(4)

    def check():
        for t in ("a", "b"):
            got = tb.get(t)
            assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
            np.testing.assert_array_equal(got.numpy(), np.asarray(jb.get(t)))
        assert tb.fills == jb.fills

    ids_a = rng.choice(N, 500, replace=False)
    for bank in (jb, tb):
        bank.register("a", ids=ids_a)
        bank.register("b", mask=np.arange(N) % 5 == 0)
    check()
    soft = rng.choice(N, 200, replace=False)
    jeng.remove(soft, hard=False)
    teng.remove(soft, hard=False)
    check()
    jb.extend("a", [1, 2, 3])
    tb.extend("a", [1, 2, 3])
    check()
    X = rng.normal(size=(N, D)).astype(np.float32)    # grows the capacity
    np.testing.assert_array_equal(teng.add(X), jeng.add(X))
    check()
    assert tb.get("a").shape[0] == teng.index.alive.shape[0] > N
    jmeta, jarr = jb.state()
    tmeta, tarr = tb.state()
    assert jmeta == tmeta and sorted(jarr) == sorted(tarr)
    for k in jarr:
        np.testing.assert_array_equal(tarr[k], jarr[k])


def _walk(cb, t):
    """One event script on a circuit breaker with a fake clock → the
    states and allow() answers seen."""
    seen = []
    for ev, when in (("f", 0), ("f", 0), ("a", 0), ("a", 9.9), ("a", 10.0),
                     ("a", 10.0), ("f", 10.0), ("a", 20.0), ("s", 20.0),
                     ("f", 20.0), ("s", 20.0), ("f", 20.0), ("f", 20.0)):
        t[0] = when
        if ev == "f":
            cb.record_failure()
        elif ev == "s":
            cb.record_success()
        else:
            seen.append(cb.allow())
        seen.append(cb.state)
    return seen


def test_circuit_breaker_walks_like_jax():
    tj, tt = [0.0], [0.0]
    cj = jax_health.CircuitBreaker(fail_threshold=2, reset_after_s=10.0,
                                   clock=lambda: tj[0])
    ct = CircuitBreaker(fail_threshold=2, reset_after_s=10.0, clock=lambda: tt[0])
    assert _walk(ct, tt) == _walk(cj, tj)
    hj, ht = jax_health.HealthTracker(fail_threshold=1), HealthTracker(fail_threshold=1)
    for h in (hj, ht):
        h.failure(2)
        h.failure("replica")
    np.testing.assert_array_equal(ht.mask(5), hj.mask(5))
    assert ht.snapshot() == hj.snapshot()
    assert shards_ok_from_mask(ht.mask(5)) == jax_health.shards_ok_from_mask(hj.mask(5))


# ------------------------------------------------------- the engine repair
def test_engine_pads_to_the_bucket_and_runs_tiles_at_bq(engine, ds, monkeypatch):
    """search_request pads to JAX's bucket (next power of two >= 8, capped
    at bq), passes it as the tile, runs every tile at bq rows and drops
    the pad rows' results."""
    calls = []
    real = engine_mod.search_jit_batched

    def spy(packed, Q, **kw):
        calls.append((Q.shape[0], kw["bq"], kw["tile_rows"]))
        return real(packed, Q, **kw)

    monkeypatch.setattr(engine_mod, "search_jit_batched", spy)
    for nq in (1, 8, 9, 17, 32):
        assert engine.search_request(ds.Q[:nq], SearchParams(k=5)).ids.shape == (nq, 5)
    assert calls == [(8, 8, 128), (8, 8, 128), (16, 16, 128), (32, 32, 128),
                     (32, 32, 128)]


def test_filter_dev_seam_skips_serving_filter(engine, ds):
    """A pre-composed device bitmap replaces serving_filter and escalates
    as params.escalate says; results equal the same subset given as
    filter_ids."""
    keep = np.arange(0, N, 7)
    bm = engine.index.filter_bitmap(ids=keep)
    for esc in (True, False):
        a = engine.search_request(ds.Q, SearchParams(k=6, escalate=esc), _filter_dev=bm)
        b = engine.search_request(ds.Q, SearchParams(k=6, escalate=esc, filter_ids=keep))
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.scores, b.scores)
        assert a.escalated == esc
    assert (a.ids[a.ids >= 0] % 7 == 0).all()


@pytest.mark.parametrize("nq", [1, 3, 9, 17, 33, 64, 100])
def test_query_bits_do_not_depend_on_the_batch(engine, ds, nq):
    """A query's ids and scores inside a batch of nq equal its solo bits,
    at every bucket from 8 to 128 (the padding repair)."""
    Q = np.concatenate([ds.Q] * 4)[:nq]
    r = engine.search_request(Q, SearchParams(k=7))
    for i in range(0, nq, max(1, nq // 5)):
        s = engine.search_request(Q[i:i + 1], SearchParams(k=7))
        np.testing.assert_array_equal(r.ids[i], s.ids[0])
        np.testing.assert_array_equal(r.scores[i], s.scores[0])


# ------------------------------------------------------------- determinism
def test_coalesced_equals_solo(ds, engine, make_fe):
    """Concurrent single-query clients coalesce into shared dispatches;
    every client's rows are bitwise the solo engine answer."""
    solo = {i: engine.search(ds.Q[i:i + 1], k=6) for i in range(NQ)}
    fe = make_fe(engine, policy="local", default_deadline_ms=200.0)
    results = {}

    def client(i):
        results[i] = fe.submit(ds.Q[i:i + 1], SearchParams(k=6)).result(timeout=T_OUT)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(NQ)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=T_OUT)
        assert not t.is_alive()
    stats = dict(fe.stats)
    assert stats["requests"] == NQ
    assert stats["dispatches"] < NQ          # coalescing actually happened
    assert stats["coalesced"] == NQ - stats["dispatches"]
    for i in range(NQ):
        assert np.array_equal(results[i].ids, solo[i][0]), i
        assert np.array_equal(results[i].scores, solo[i][1]), i
        assert results[i].batch_size >= 1
        assert results[i].queued_us >= 0.0


def test_inline_filter_dispatches_solo(ds, engine, make_fe):
    mask = np.zeros(N, np.uint8)
    mask[: N // 4] = 1
    ref_ids, ref_sc = engine.search(ds.Q[:3], k=5, filter_mask=mask)
    fe = make_fe(engine, policy="local")
    r = fe.submit(ds.Q[:3], SearchParams(k=5, filter_mask=mask)).result(timeout=T_OUT)
    assert fe.stats["dispatches"] == 1 and r.batch_size == 3
    assert np.array_equal(r.ids, ref_ids)
    assert np.array_equal(r.scores, ref_sc)


def test_coalescing_uses_the_solo_buckets(ds, engine, make_fe, monkeypatch):
    """The port's counterpart of JAX's no-recompilation test: coalesced
    dispatch runs only at the padded shapes solo traffic of the same
    sizes runs at (buckets 8, 16, 32, tiles at bq rows)."""
    shapes = []
    real = engine_mod.search_jit_batched

    def spy(packed, Q, **kw):
        shapes.append((Q.shape[0], kw["bq"], kw["tile_rows"]))
        return real(packed, Q, **kw)

    monkeypatch.setattr(engine_mod, "search_jit_batched", spy)
    for nq in (1, 9, 17):            # the buckets 8, 16, 32
        engine.search(ds.Q[:nq], k=6)
    solo = set(shapes)
    shapes.clear()
    fe = make_fe(engine, policy="local", max_batch=32, default_deadline_ms=100.0)
    futs = []
    for i in range(24):              # mixed sizes, concurrent arrival
        nq = 1 + (i % 3)
        futs.append(fe.submit(ds.Q[i % NQ:i % NQ + nq], SearchParams(k=6)))
    for f in futs:
        f.result(timeout=T_OUT)
    assert shapes and set(shapes) <= solo


# --------------------------------------------------------- deadline flushes
def test_deadline_flushes_partial_batch(ds, engine, make_fe):
    """max_delay_ms=None → pure half-deadline policy: a partial batch
    (3 ≪ max_batch) must dispatch once half the 80 ms budget is spent,
    not wait for the batch to fill."""
    fe = make_fe(engine, policy="local", max_batch=64, max_delay_ms=None)
    t0 = time.perf_counter()
    futs = [fe.submit(ds.Q[i:i + 1], SearchParams(k=5, deadline_ms=80.0))
            for i in range(3)]
    res = [f.result(timeout=5.0) for f in futs]
    elapsed_ms = (time.perf_counter() - t0) * 1e3
    assert all(r.batch_size == 3 for r in res)   # one coalesced dispatch
    assert fe.stats["dispatches"] == 1
    assert elapsed_ms < 5_000


def test_max_delay_clamps_generous_deadlines(ds, engine, make_fe):
    """A 10 s deadline must NOT stall the queue 5 s — max_delay_ms caps
    the batching wait."""
    fe = make_fe(engine, policy="local", max_batch=64, max_delay_ms=5.0)
    t0 = time.perf_counter()
    fe.submit(ds.Q[:1], SearchParams(k=5, deadline_ms=10_000.0)).result(timeout=T_OUT)
    assert time.perf_counter() - t0 < 3.0


def test_asearch_awaits_the_future(ds, engine, make_fe):
    fe = make_fe(engine, policy="local", max_delay_ms=1.0)
    r = asyncio.run(asyncio.wait_for(fe.asearch(ds.Q[:2], SearchParams(k=4)), T_OUT))
    np.testing.assert_array_equal(r.ids, engine.search(ds.Q[:2], k=4)[0])


# ---------------------------------------------------------- tenant filters
def test_tenant_filter_serving(ds, engine, make_fe):
    ids_t0 = np.flatnonzero(np.arange(N) % 3 == 0)
    fe = make_fe(engine, policy="local")
    fe.register_tenant("t0", ids=ids_t0)
    r = fe.submit(ds.Q, SearchParams(k=6, tenant="t0")).result(timeout=T_OUT)
    # tenant serving == engine-level subset filtering, bitwise
    ref_ids, ref_sc = engine.search(ds.Q, k=6, filter_ids=ids_t0)
    assert np.array_equal(r.ids, ref_ids)
    assert np.array_equal(r.scores, ref_sc)
    ok = r.ids[r.ids >= 0]
    assert (ok % 3 == 0).all()
    with pytest.raises(UnknownTenantError):
        fe.submit(ds.Q[:1], SearchParams(k=3, tenant="nope"))


def test_tenant_lru_eviction_and_epoch_invalidation(ds, engine):
    bank = TenantFilterBank(engine.index, capacity=2)
    for t in ("a", "b", "c"):
        bank.register(t, ids=np.arange(100))
    bank.get("a")
    bank.get("b")
    assert bank.fills == 2
    bank.get("a")
    bank.get("b")                              # steady state: cache hits
    assert bank.fills == 2
    bank.get("c")                              # fills + evicts "a" (LRU)
    assert bank.fills == 3 and "a" not in bank._cache
    bank.get("a")                              # rebuilt after eviction
    assert bank.fills == 4
    engine.remove([0, 1], hard=False)          # mutation bumps the epoch
    bank.get("a")                              # stale → rebuild
    assert bank.fills == 5
    assert int(bank.get("a")[0]) == 0          # tombstone composed in
    assert bank.fills == 5                     # second get in-epoch: hit
    bank.extend("a", [200, 201])               # registry bump → rebuild
    assert int(bank.get("a")[200]) == 1
    assert bank.fills == 6
    assert bank.get("a").device == engine.index.device


def test_tenant_coalescing_same_tenant_only(ds, engine, make_fe):
    """Same-tenant requests share a dispatch; different tenants never
    share one (their filter bitmaps differ)."""
    fe = make_fe(engine, policy="local", default_deadline_ms=200.0)
    fe.register_tenant("a", ids=np.arange(0, N, 2))
    fe.register_tenant("b", ids=np.arange(1, N, 2))
    futs = ([fe.submit(ds.Q[i:i + 1], SearchParams(k=4, tenant="a"))
             for i in range(4)]
            + [fe.submit(ds.Q[i:i + 1], SearchParams(k=4, tenant="b"))
               for i in range(4)])
    res = [f.result(timeout=T_OUT) for f in futs]
    assert all(r.tenant == "a" for r in res[:4])
    assert all(r.tenant == "b" for r in res[4:])
    for r in res[:4]:
        assert (r.ids[r.ids >= 0] % 2 == 0).all()
    for r in res[4:]:
        assert (r.ids[r.ids >= 0] % 2 == 1).all()
    assert fe.stats["dispatches"] >= 2


# ------------------------------------------------------- mutation barriers
def test_mutation_is_a_barrier(ds, engine, make_fe):
    """Searches queued before a mutation serve the old epoch; searches
    queued after it serve the new one — even when everything is enqueued
    back-to-back before the dispatcher wakes."""
    fe = make_fe(engine, policy="local", max_batch=64, max_delay_ms=5.0)
    e0 = engine.index._alive_epoch
    pre = [fe.submit(ds.Q[i:i + 1], SearchParams(k=5, deadline_ms=10_000.0))
           for i in range(3)]
    mfut: Future = Future()
    fe._enqueue(_Request("remove", mfut, payload=(np.arange(N), False)))
    post = [fe.submit(ds.Q[i:i + 1], SearchParams(k=5, deadline_ms=10_000.0))
            for i in range(3)]
    pre_r = [f.result(timeout=T_OUT) for f in pre]
    assert mfut.result(timeout=T_OUT) == N
    post_r = [f.result(timeout=T_OUT) for f in post]
    for r in pre_r:                  # served before the tombstoning
        assert r.epoch == e0
        assert (r.ids >= 0).any()
    for r in post_r:                 # served after: everything is dead
        assert r.epoch > e0
        assert (r.ids == -1).all()


def test_add_with_tenant_is_atomic(ds, engine, make_fe):
    """add(tenant=...) extends the tenant's standing filter in the same
    barrier as the insert: the fresh points are immediately findable
    under their tenant, and only the allowed ids are ever served."""
    rng = np.random.default_rng(7)
    fe = make_fe(engine, policy="local")
    fe.register_tenant("t", ids=[0])
    new = rng.normal(size=(5, D)).astype(np.float32)
    ids = fe.add(new, tenant="t")
    allowed = {0, *map(int, ids)}
    r = fe.submit(new, SearchParams(k=3, tenant="t")).result(timeout=T_OUT)
    served = set(map(int, r.ids[r.ids >= 0]))
    assert served and served <= allowed
    # a brand-new tenant can be created by its first add, too
    ids2 = fe.add(new, tenant="fresh")
    r2 = fe.submit(new, SearchParams(k=3, tenant="fresh")).result(timeout=T_OUT)
    srv2 = set(map(int, r2.ids[r2.ids >= 0]))
    assert srv2 and srv2 <= set(map(int, ids2))


def test_barrier_stress_under_fast_switching(ds, engine, make_fe):
    """12 searching threads (more than the cores) against a mutator that
    removes and re-adds points through the front-end, with a short switch
    interval: each client's epochs never decrease, no result returns an id
    removed at or before its epoch, and the cost accounting balances."""
    fe = make_fe(engine, policy="local", max_batch=32, max_delay_ms=1.0)
    removed_at = {}                  # id -> epoch its removal produced
    lock = threading.Lock()
    errors = []
    stop = threading.Event()

    def client(c):
        last = -1
        for i in range(15):
            r = fe.submit(ds.Q[(c + i) % NQ:(c + i) % NQ + 1],
                          SearchParams(k=5)).result(timeout=T_OUT)
            with lock:
                bad = [x for x in r.ids[r.ids >= 0].tolist()
                       if removed_at.get(x, r.epoch + 1) <= r.epoch]
            if r.epoch < last or bad:
                errors.append((c, r.epoch, last, bad))
            last = r.epoch

    def mutator():
        try:
            mutate()
        except Exception as e:       # reported below, not lost in the thread
            errors.append(e)

    def mutate():
        rng = np.random.default_rng(11)
        live, vecs = np.arange(N), ds.X
        while not stop.is_set():
            victims = rng.choice(live, 50, replace=False)
            fe.remove(victims)
            with lock:
                e = engine.index._alive_epoch
                removed_at.update({int(v): e for v in victims})
            live = np.setdiff1d(live, victims)
            new = fe.add(vecs[victims])
            vecs = np.concatenate([vecs, vecs[victims]])
            assert (new == np.arange(len(vecs) - 50, len(vecs))).all()
            live = np.concatenate([live, new])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        m = threading.Thread(target=mutator)
        threads = [threading.Thread(target=client, args=(c,)) for c in range(12)]
        m.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=T_OUT)
            assert not t.is_alive()
        stop.set()
        m.join(timeout=T_OUT)
        assert not m.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[:3]
    assert fe.stats["mutations"] >= 2 and fe.stats["requests"] == 12 * 15
    fe.flush()
    assert fe._cost == 0


# -------------------------------------------------------------- durability
def test_save_open_round_trip(tmp_path, ds, engine, make_fe):
    fe = make_fe(engine, policy="local", max_batch=48, max_delay_ms=3.0,
                 default_deadline_ms=77.0)
    fe.register_tenant("acme", ids=np.arange(0, N, 5))
    ref = fe.submit(ds.Q, SearchParams(k=6, tenant="acme")).result(timeout=T_OUT)
    fe.save(str(tmp_path / "snap"))
    fe.close()
    fe2 = ServingFrontend.open(str(tmp_path / "snap"), device="cpu")
    try:
        assert fe2.max_batch == 48 and fe2.max_delay_ms == 3.0
        assert fe2.default_deadline_ms == 77.0
        assert fe2.tenants.tenants == ["acme"]
        r = fe2.submit(ds.Q, SearchParams(k=6, tenant="acme")).result(timeout=T_OUT)
        assert np.array_equal(r.ids, ref.ids)
        assert np.array_equal(r.scores, ref.scores)
    finally:
        fe2.close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingFrontend.open(str(tmp_path / "snap"))


def test_close_rejects_new_work(ds, engine):
    fe = ServingFrontend(engine, policy="local")
    fe.submit(ds.Q[:1], SearchParams(k=3)).result(timeout=T_OUT)
    fe.close()
    fe.close()                                    # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        fe.submit(ds.Q[:1], SearchParams(k=3))
    assert not fe._thread.is_alive()


# ----------------------------------------------------------- replica policy
def test_replicated_search_equals_local(engine, ds):
    """make_replicated_search over two CPU replicas: the same bits as the
    engine's local path, with and without a tenant filter; the copies are
    reused while the snapshot is unchanged and remade after a mutation."""
    eng = engine
    mult = 1 + max(eng.index.n_spills, 1)
    Qp, nq, bq = pad_queries(ds.Q[:13], eng.bq, multiple=2)
    kw = dict(top_t=eng.top_t, final_k=6, rerank_budget=eng.rerank_budget,
              multiplicity=mult, bq=bq, tile_rows=eng.bq)
    fn = make_replicated_search(CPU2, **kw)
    ids, sc = fn(eng.index.pack(), Qp)
    want = eng.search_request(ds.Q[:13], SearchParams(k=6))
    np.testing.assert_array_equal(ids[:nq].numpy(), want.ids)
    np.testing.assert_array_equal(sc[:nq].numpy(), want.scores)
    bm = eng.index.filter_bitmap(ids=np.arange(0, N, 2))
    fnf = make_replicated_search(CPU2, with_filter=True, **kw)
    ids, sc = fnf(eng.index.pack(), Qp, bm)
    want = eng.search_request(ds.Q[:13], SearchParams(k=6, filter_ids=np.arange(0, N, 2)))
    np.testing.assert_array_equal(ids[:nq].numpy(), want.ids)
    np.testing.assert_array_equal(sc[:nq].numpy(), want.scores)
    with pytest.raises(ValueError, match="replicas"):
        fn(eng.index.pack(), Qp[:7])
    p0 = eng.index.pack()
    assert eng.index.pack() is p0                 # unchanged: one snapshot
    eng.remove(np.unique(ids[:, 0].numpy()))      # the previous top hits
    assert eng.index.pack() is not p0
    ids2, _ = fn(eng.index.pack(), Qp)
    want = eng.search_request(ds.Q[:13], SearchParams(k=6))
    np.testing.assert_array_equal(ids2[:nq].numpy(), want.ids)


def test_replicated_search_takes_params(engine, ds):
    """SearchParams override the keyword budget, as in JAX; one replica is
    the local pipeline."""
    packed = engine.index.pack()
    mult = 1 + max(engine.index.n_spills, 1)
    kw = dict(final_k=6, rerank_budget=128, multiplicity=mult)
    f_kwargs = make_replicated_search(["cpu"], top_t=5, **kw)
    f_params = make_replicated_search(["cpu"], top_t=99,
                                      params=SearchParams(k=6, top_t=5, rerank_budget=128), **kw)
    Qp, nq, bq = pad_queries(ds.Q, 128)
    ref = search_jit_batched(packed, Qp, top_t=5, final_k=6, rerank_budget=128,
                             bq=bq, multiplicity=mult)
    for f in (f_kwargs, f_params):
        ids, sc = f(packed, Qp)
        assert torch.equal(ids[:nq], ref[0][:nq]) and torch.equal(sc[:nq], ref[1][:nq])


@pytest.fixture()
def two_replicas(monkeypatch):
    """The front-end sees two devices: two CPU replicas."""
    monkeypatch.setattr(frontend, "replica_devices", lambda dev: CPU2)


def test_replica_policy_multidevice(ds, engine, make_fe, two_replicas):
    solo_ids, solo_sc = engine.search(ds.Q, k=6)
    fe = make_fe(engine, policy="replica", default_deadline_ms=200.0)
    r = fe.submit(ds.Q, SearchParams(k=6)).result(timeout=T_OUT)
    assert fe.stats["replica_dispatches"] == 1
    assert np.array_equal(r.ids, solo_ids), "replica ids != local"
    assert np.array_equal(r.scores, solo_sc), "replica scores != local"
    # tenant filter under replica fan-out, still bitwise local
    fe.register_tenant("t", ids=np.arange(0, N, 2))
    rt = fe.submit(ds.Q, SearchParams(k=6, tenant="t")).result(timeout=T_OUT)
    ref_ids, ref_sc = engine.search(ds.Q, k=6, filter_ids=np.arange(0, N, 2))
    assert np.array_equal(rt.ids, ref_ids)
    assert np.array_equal(rt.scores, ref_sc)
    # "auto" on two devices picks replica
    fe.policy = "auto"
    fe.submit(ds.Q, SearchParams(k=6)).result(timeout=T_OUT)
    assert fe.stats["replica_dispatches"] == 3


@pytest.mark.parametrize("nq", [5, 13])
def test_replica_budget_pad_rows_never_escalate(ds, engine, make_fe, two_replicas,
                                                monkeypatch, nq):
    """Under escalate="budget" and a tenant filter thin enough that a zero
    (pad) row is thin, a replica dispatch of a batch padded to its bucket
    gives the local path's bits, and as many thin rows reach
    `settle_steps` as there: the pad rows never escalate. The rows are
    counted by a wrapper (spans do not record on the dispatcher thread)."""
    thin = []
    real = search_mod.settle_steps

    def spy(sub, parts, widths, multiplicity):
        thin.append(parts.shape[0])
        return real(sub, parts, widths, multiplicity)

    monkeypatch.setattr(search_mod, "settle_steps", spy)
    # six ids that no slot of a zero row's first probes holds
    zero = FlatRouter(engine.index.centroids).route(torch.zeros(1, D), engine.top_t)[1]
    keep = np.setdiff1d(np.arange(N), engine.index.pack().part_ids[zero].numpy())[::100]
    local = SearchParams(k=6, escalate="budget", filter_ids=keep)
    engine.search_request(np.zeros((1, D), np.float32), local)
    assert thin == [1], "a zero row must be thin under this filter"
    thin.clear()
    want = engine.search_request(ds.Q[:nq], local)
    n_local = sum(thin)
    assert n_local
    fe = make_fe(engine, policy="replica", default_deadline_ms=200.0)
    fe.register_tenant("t", ids=keep)
    thin.clear()
    r = fe.submit(ds.Q[:nq], SearchParams(k=6, escalate="budget", tenant="t")
                  ).result(timeout=T_OUT)
    assert fe.stats["replica_dispatches"] == 1 and not r.degraded
    np.testing.assert_array_equal(r.ids, want.ids)
    np.testing.assert_array_equal(r.scores, want.scores)
    assert sum(thin) == n_local


def test_one_device_serves_locally(ds, engine, make_fe):
    """On one device (here the CPU) "auto" and "replica" serve locally."""
    assert len(frontend.replica_devices(engine.index.device)) == 1
    for policy in ("auto", "replica"):
        fe = make_fe(engine, policy=policy)
        fe.submit(ds.Q[:3], SearchParams(k=4)).result(timeout=T_OUT)
        assert fe.stats["replica_dispatches"] == 0


# =================================================== resilience (§3.13)
def _stall_search(fe, ds, ms):
    """Park the dispatcher inside a search dispatch for ~ms via a latency
    spike on engine:search (hit 1 only), so subsequent submits pile up in
    the queue deterministically. Returns the sacrificial future."""
    faults.inject("engine:search@1x1", mode="delay", delay_ms=ms)
    fut = fe.submit(ds.Q[:1], SearchParams(k=3))
    t0 = time.perf_counter()
    while fe._q and time.perf_counter() - t0 < 5.0:
        time.sleep(0.001)
    assert not fe._q, "dispatcher never picked up the stall request"
    return fut


def _stall_mutation(fe, ms):
    """Same, but inside a mutation (engine:add) — keeps the engine:search
    hit counter untouched for plans armed on it."""
    faults.inject("engine:add@1x1", mode="delay", delay_ms=ms)
    mfut: Future = Future()
    X = np.zeros((1, D), np.float32)
    fe._enqueue(_Request("add", mfut, payload=(X, None),
                         t_admit=time.perf_counter(), cost=1))
    t0 = time.perf_counter()
    while fe._q and time.perf_counter() - t0 < 5.0:
        time.sleep(0.001)
    assert not fe._q, "dispatcher never picked up the stall mutation"
    return mfut


# ------------------------------------------------------------ taxonomy
def test_error_taxonomy():
    e = OverloadedError("full", queued_us=5.0)
    assert isinstance(e, ServingError) and isinstance(e, RuntimeError)
    assert e.queued_us == 5.0 and e.engine_us == 0.0
    assert is_retryable(e)                       # the caller may back off
    assert not is_retryable(DeadlineExceededError("late"))
    assert not is_retryable(FrontendClosedError("closed"))
    assert is_retryable(InjectedTransientFault("x"))
    assert not is_retryable(InjectedFault("x"))
    assert is_retryable(TimeoutError())
    assert is_retryable(ConnectionError())
    assert not is_retryable(ValueError())


def test_deadline_param_bounds():
    assert SearchParams(deadline_ms=0.05).validate().deadline_ms == 0.05
    assert SearchParams(deadline_ms=600_000).validate().deadline_ms == 600_000.0
    assert SearchParams().validate().deadline_ms is None
    for bad in (0, 0.01, -5, 600_001, float("nan")):
        with pytest.raises(ValueError, match="deadline_ms"):
            SearchParams(deadline_ms=bad).validate()


# ------------------------------------------------------- fault grammar
def test_fault_window_grammar():
    plan = FaultPlan.parse("p@2x3", mode="error")
    assert (plan.point, plan.hits, plan.times) == ("p", 2, 3)
    faults.install("p@2x3", mode="error")
    fired = []
    for _ in range(6):
        try:
            faults.serve_point("p")
            fired.append(False)
        except InjectedFault:
            fired.append(True)
    assert fired == [False, True, True, True, False, False]


def test_fault_multi_plan_and_shim_share_state():
    faults.install("a@1;b@1", mode="transient")
    with pytest.raises(InjectedTransientFault):
        faults.serve_point("a")
    with pytest.raises(InjectedTransientFault):
        faults.serve_point("b")
    from repro_torch.ckpt import faults as shim
    assert shim.InjectedCrash is faults.InjectedCrash
    assert shim.InjectedFault is faults.InjectedFault
    shim.inject("c@1", mode="error")             # append through the shim
    with pytest.raises(InjectedFault):
        faults.serve_point("c")                  # ...fires via the module


def test_fault_delay_mode_is_a_latency_spike():
    faults.install("d", mode="delay", delay_ms=30.0)
    t0 = time.perf_counter()
    faults.serve_point("d")                      # sleeps, does not raise
    assert time.perf_counter() - t0 >= 0.025


# ------------------------------------------------------ circuit breaker
def test_circuit_breaker_state_machine():
    t = [0.0]
    cb = CircuitBreaker(fail_threshold=2, reset_after_s=10.0, clock=lambda: t[0])
    assert cb.state == CLOSED and cb.allow()
    cb.record_failure()
    assert cb.state == CLOSED                    # under threshold
    cb.record_failure()
    assert cb.state == OPEN and not cb.allow()
    t[0] = 9.9
    assert not cb.allow()                        # window not elapsed
    t[0] = 10.0
    assert cb.state == HALF_OPEN
    assert cb.allow()                            # the single probe
    assert not cb.allow()                        # concurrent caller denied
    cb.record_failure()                          # failed probe re-arms
    assert cb.state == OPEN
    t[0] = 20.0
    assert cb.allow()
    cb.record_success()
    assert cb.state == CLOSED and cb.allow()
    cb.record_failure()
    cb.record_success()                          # success resets the streak
    cb.record_failure()
    assert cb.state == CLOSED
    for bad in (dict(fail_threshold=0), dict(reset_after_s=0)):
        with pytest.raises(ValueError):
            CircuitBreaker(**bad)


def test_health_tracker_mask_and_shards_ok():
    h = HealthTracker(fail_threshold=1, reset_after_s=60.0)
    h.failure(2)
    m = h.mask(4)
    assert m.tolist() == [1, 1, 0, 1]
    assert shards_ok_from_mask(m) == (0, 1, 3)
    assert h.healthy(range(4)) == (0, 1, 3)
    assert h.snapshot()[2] == OPEN
    assert h.mask(3, ok=[0]).tolist() == [1, 0, 0]


# ---------------------------------------------------- admission control
def test_admission_reject(ds, engine, make_fe):
    fe = make_fe(engine, policy="local", max_queue=4, overload="reject",
                 max_delay_ms=1.0, mutation_cost=2)
    _stall_search(fe, ds, 500.0)
    futs = [fe.submit(ds.Q[i:i + 1], SearchParams(k=4)) for i in range(4)]
    with pytest.raises(OverloadedError):
        fe.submit(ds.Q[:1], SearchParams(k=4))
    # an over-budget mutation is rejected, never admitted by eviction
    with pytest.raises(OverloadedError):
        fe._enqueue(_Request("add", Future(), payload=(None, None),
                             t_admit=time.perf_counter(), cost=2))
    assert fe.stats["rejected"] == 2
    for f in futs:                           # admitted work completes
        assert f.result(timeout=T_OUT).ids.shape == (1, 4)
    fe.close()
    assert fe._cost == 0                     # cost accounting balances


def test_admission_shed_oldest(ds, engine, make_fe):
    fe = make_fe(engine, policy="local", max_queue=4, overload="shed-oldest",
                 max_delay_ms=1.0, mutation_cost=2)
    _stall_search(fe, ds, 500.0)
    # least slack: the only request with an explicit deadline
    doomed = fe.submit(ds.Q[:1], SearchParams(k=4, deadline_ms=5_000.0))
    keep = [fe.submit(ds.Q[i:i + 1], SearchParams(k=4)) for i in range(1, 4)]
    newcomer = fe.submit(ds.Q[4:5], SearchParams(k=4))
    with pytest.raises(OverloadedError) as ei:
        doomed.result(timeout=5)
    assert ei.value.queued_us >= 0.0
    assert fe.stats["shed"] == 1
    # a mutation must NOT evict queued searches under shed-oldest
    with pytest.raises(OverloadedError):
        fe._enqueue(_Request("add", Future(), payload=(None, None),
                             t_admit=time.perf_counter(), cost=2))
    assert fe.stats["rejected"] == 1
    for f in keep + [newcomer]:
        assert f.result(timeout=T_OUT).ids.shape == (1, 4)
    fe.close()
    assert fe._cost == 0


# -------------------------------------------------- deadline enforcement
def test_deadline_expiry_sheds_queued(ds, engine, make_fe):
    fe = make_fe(engine, policy="local", max_delay_ms=1.0)
    fe.submit(ds.Q[:1], SearchParams(k=4)).result(timeout=T_OUT)
    _stall_search(fe, ds, 300.0)
    doomed = fe.submit(ds.Q[:1], SearchParams(k=4, deadline_ms=50.0))
    ok = fe.submit(ds.Q[1:2], SearchParams(k=4))  # best-effort
    with pytest.raises(DeadlineExceededError) as ei:
        doomed.result(timeout=30)
    assert ei.value.queued_us >= 50e3 * 0.9  # spent >= ~the budget
    assert ei.value.engine_us == 0.0         # never reached the engine
    assert ok.result(timeout=T_OUT).ids.shape == (1, 4)  # best-effort never expires
    assert fe.stats["expired"] == 1


# ------------------------------------------------ containment and retry
def test_transient_fault_absorbed_by_retry(ds, engine, make_fe):
    want = engine.search_request(ds.Q[:2], SearchParams(k=4))
    faults.install("engine:search@1x2", mode="transient")
    fe = make_fe(engine, policy="local", max_delay_ms=1.0, retry_backoff_ms=0.5)
    r = fe.submit(ds.Q[:2], SearchParams(k=4)).result(timeout=T_OUT)
    assert r.retries == 2                    # two blips absorbed
    assert fe.stats["retries"] == 2
    assert fe.stats["failures"] == 0
    assert np.array_equal(r.ids, want.ids)
    assert np.array_equal(r.scores, want.scores)


def test_nonretryable_fault_fails_only_its_group(ds, engine, make_fe):
    faults.install("engine:search@1x1", mode="error")
    fe = make_fe(engine, policy="local", max_delay_ms=1.0)
    with pytest.raises(InjectedFault):
        fe.submit(ds.Q[:1], SearchParams(k=4)).result(timeout=T_OUT)
    assert fe.stats["failures"] == 1
    r = fe.submit(ds.Q[:1], SearchParams(k=4)).result(timeout=T_OUT)   # keeps serving
    assert r.ids.shape == (1, 4) and r.retries == 0


def test_retry_budget_is_bounded(ds, engine, make_fe):
    faults.install("engine:search", mode="transient")   # permanently down
    fe = make_fe(engine, policy="local", max_delay_ms=1.0, max_retries=1,
                 retry_backoff_ms=0.5)
    with pytest.raises(InjectedTransientFault):
        fe.submit(ds.Q[:1], SearchParams(k=4)).result(timeout=T_OUT)
    assert fe.stats["retries"] == 1 and fe.stats["failures"] == 1
    faults.uninstall()
    assert fe.submit(ds.Q[:1], SearchParams(k=4)).result(timeout=T_OUT).ids.shape == (1, 4)


def test_mutations_never_retried(ds, engine, make_fe):
    faults.install("engine:add@1x1", mode="transient")
    fe = make_fe(engine, policy="local", max_delay_ms=1.0)
    with pytest.raises(InjectedTransientFault):
        fe.add(np.zeros((1, D), np.float32))
    assert fe.stats["retries"] == 0          # retryable, but a write
    assert fe.stats["failures"] == 1
    assert fe.submit(ds.Q[:1], SearchParams(k=4)).result(timeout=T_OUT).ids.shape == (1, 4)


def test_jax_fault_plans_do_not_reach_the_port(ds, engine, make_fe):
    """A plan installed in the JAX package's faults module does not fire
    in the port's front-end (the two keep their plans apart)."""
    jax_faults.install("engine:search", mode="error")
    fe = make_fe(engine, policy="local", max_delay_ms=1.0)
    assert fe.submit(ds.Q[:1], SearchParams(k=4)).result(timeout=T_OUT).ids.shape == (1, 4)
    assert fe.stats["failures"] == 0


# ------------------------------------------- stranded-Future regression
def test_dispatcher_death_strands_no_futures(ds, engine):
    fe = ServingFrontend(engine, policy="local", max_delay_ms=1.0)
    mfut = _stall_mutation(fe, 400.0)
    faults.inject("engine:search@1", mode="raise")   # BaseException
    s1 = fe.submit(ds.Q[:1], SearchParams(k=3))      # dispatched first
    s2 = fe.submit(ds.Q[:1], SearchParams(k=4))      # queued behind it
    assert mfut.result(timeout=30) is not None       # stall add completed
    with pytest.raises(InjectedCrash):
        s1.result(timeout=30)                        # in-flight: the cause
    with pytest.raises(FrontendClosedError):
        s2.result(timeout=30)                        # queued: failed fast
    faults.uninstall()
    with pytest.raises(FrontendClosedError, match="closed"):
        fe.submit(ds.Q[:1], SearchParams(k=3))       # submit is poisoned
    fe.close()                                       # returns promptly
    assert not fe._thread.is_alive()
    assert fe._cost == 0


# ---------------------------------------------------- shutdown ordering
def test_close_during_inflight_mutation(ds, engine):
    fe = ServingFrontend(engine, policy="local", max_delay_ms=1.0)
    mfut = _stall_mutation(fe, 400.0)
    t0 = time.perf_counter()
    fe.close()                                       # mutation in flight
    assert time.perf_counter() - t0 < 30.0
    assert mfut.result(timeout=1) is not None        # the write finished
    assert not fe._thread.is_alive()


def test_close_without_drain_fails_queued_work(ds, engine, make_fe):
    fe = make_fe(engine, policy="local", max_delay_ms=1.0)
    _stall_search(fe, ds, 400.0)
    queued = [fe.submit(ds.Q[i:i + 1], SearchParams(k=4)) for i in range(3)]
    fe.close(drain=False)
    for f in queued:
        with pytest.raises(FrontendClosedError):
            f.result(timeout=5)
    with pytest.raises(FrontendClosedError):
        fe.submit(ds.Q[:1], SearchParams(k=4))
    assert fe._cost == 0


def test_concurrent_submits_racing_close(ds, engine):
    fe = ServingFrontend(engine, policy="local", max_delay_ms=1.0)
    fe.submit(ds.Q[:1], SearchParams(k=4)).result(timeout=T_OUT)
    futs, lock = [], threading.Lock()

    def client():
        for i in range(30):
            try:
                f = fe.submit(ds.Q[i % NQ:i % NQ + 1], SearchParams(k=4))
            except FrontendClosedError:
                return
            with lock:
                futs.append(f)

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.005)
    fe.close()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    # every accepted Future completes — served or failed, never hung
    done = sum(1 for f in futs if f.result(timeout=30).ids.shape == (1, 4))
    assert done == len(futs)
    assert not fe._thread.is_alive()


# --------------------------------------------- durability composition
def test_wal_crash_behind_frontend_recovers_bitwise(ds, engine, tmp_path):
    """A crash after the log record is durable ("wal:record") but before
    the mutation applies recovers to exactly the post-mutation state on
    reopen."""
    p, pref = str(tmp_path / "live"), str(tmp_path / "ref")
    engine.save(p)
    engine.save(pref)
    add = np.linspace(-1, 1, 3 * D, dtype=np.float32).reshape(3, D)
    fe = ServingFrontend(AnnEngine.open(p, wal=True, device="cpu"), policy="local",
                         max_delay_ms=1.0)
    fe.submit(ds.Q[:2], SearchParams(k=5)).result(timeout=T_OUT)
    faults.install("wal:record")
    with pytest.raises(InjectedCrash):
        fe.add(add)                              # crash mid-mutation
    faults.uninstall()
    with pytest.raises(FrontendClosedError):
        fe.submit(ds.Q[:1], SearchParams(k=5))   # front-end is dead
    fe.close()
    fe.engine.index._wal.close()
    ref = AnnEngine.open(pref, device="cpu")     # the committed state:
    ref.add(add)                                 # snapshot + the logged add
    want = ref.search(ds.Q, k=5)
    reopened = AnnEngine.open(p, device="cpu")   # log replay on open
    got = reopened.search(ds.Q, k=5)
    reopened.index._wal.close()
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


# ------------------------------------------------- degraded fan-out
def test_replica_breaker_fallback_multidevice(ds, engine, make_fe, two_replicas):
    """A failing replica dispatch falls back to local serving flagged
    degraded; the breaker opens, stops trying, and heals through the
    half-open probe; every answer is the local bits."""
    solo_ids, solo_sc = engine.search(ds.Q[:16], k=6)
    fe = make_fe(engine, policy="replica", breaker_threshold=2, breaker_reset_s=0.5)
    plan = faults.install("replica:dispatch", mode="error")  # replicas down

    def search():
        return fe.submit(ds.Q[:16], SearchParams(k=6)).result(timeout=T_OUT)

    r1 = search()
    assert r1.degraded, "fallback must be flagged"
    assert np.array_equal(r1.ids, solo_ids)        # full-coverage local serve
    assert np.array_equal(r1.scores, solo_sc)
    r2 = search()                                  # second failure trips it
    assert r2.degraded and fe.health.state("replica") == "open"
    r3 = search()                                  # breaker open: no attempt
    assert r3.degraded and plan._hit_count == 2
    assert np.array_equal(r3.ids, solo_ids)
    assert fe.stats["degraded"] == 3
    assert fe.stats["replica_dispatches"] == 0
    faults.uninstall()
    time.sleep(0.6)                                # reset window elapses
    r4 = search()                                  # half-open probe heals it
    assert not r4.degraded
    assert fe.health.state("replica") == "closed"
    assert fe.stats["replica_dispatches"] == 1
    assert np.array_equal(r4.ids, solo_ids)        # replica path stays bitwise
    assert np.array_equal(r4.scores, solo_sc)
