"""The port's kNN attention memory (repro_torch.serve.knn_memory) against
the JAX package, on the CPU.

A JAX `KNNMemory` is carried across with `convert.knn_memory_from_numpy`;
both then take the same script (adds with segment labels, hard and soft
evictions) with their state equal bit for bit after it, and the same
retrievals on both engines: ids equal on >= 0.995 of slots, `attend`
within rtol 1e-4 / atol 1e-5 on the rows whose ids agree (the port
computes the softmax in f32 torch, JAX in numpy, which promotes to f64),
and `exact_topk_attention` within the same tolerance with the same id
sets. Inside the port: tests/test_knn_memory.py's quality bars and the
KNNMemory cases of tests/test_serve_api.py. 20,000 keys x 32, inputs made
by numpy from a seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve.knn_memory import KNNMemory as JaxKNNMemory  # noqa: E402
from repro.serve.knn_memory import \
    exact_topk_attention as jax_exact_topk_attention  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.serve.api import DEFAULT_TOP_T, SearchParams  # noqa: E402
from repro_torch.serve.engine import AnnEngine  # noqa: E402
from repro_torch.serve.knn_memory import KNNMemory, exact_topk_attention  # noqa: E402

HD, N_CTX, NQ = 32, 20_000, 64
STATE = ("part_ids", "part_codes", "sizes", "rerank", "assignments", "alive")
COUNTS = ("n_total", "n_dead_slots", "n_soft_deleted", "wal_seq")
ENGINES = ["numpy", "jit"]


def manifold(seed, n, d, nq, p=8, hidden=64):
    """Unit vectors on a p-dimensional manifold (a random two-layer map),
    made by numpy: (X (n, d), Q (nq, d)) f32."""
    rng = np.random.default_rng(seed)
    W1 = rng.standard_normal((p, hidden))
    W2 = rng.standard_normal((hidden, d)) / np.sqrt(hidden)
    Y = np.tanh(2.0 * rng.standard_normal((n + nq, p)) @ W1 / np.sqrt(p)) @ W2
    Y = (Y / np.linalg.norm(Y, axis=1, keepdims=True)).astype(np.float32)
    return Y[:n], Y[n:]


def knn_fields(mem):
    """A JAX KNNMemory's state as convert.knn_memory_from_numpy's fields."""
    m = mem.index
    index = {k: getattr(m, k) for k in STATE + COUNTS + (
        "centroids", "spill_mode", "lam", "n_spills", "compact_threshold")}
    index["pq.centers"] = None if m.pq is None else np.asarray(m.pq.centers)
    return {"index": index, "values": mem.values, "segments": mem.segments,
            "engine": mem.engine, "top_t": mem.top_t}


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_same_memory(a, b):
    """Two memories (either package) equal bit for bit: index state,
    counters, value and segment buffers, engine, top_t."""
    for k in STATE + ("centroids",):
        np.testing.assert_array_equal(_np(getattr(a.index, k)), _np(getattr(b.index, k)),
                                      err_msg=k)
    for k in COUNTS:
        assert getattr(a.index, k) == getattr(b.index, k), k
    np.testing.assert_array_equal(_np(a.values), _np(b.values))
    np.testing.assert_array_equal(_np(a.segments), _np(b.segments))
    assert (a.engine, a.top_t) == (b.engine, b.top_t)


@pytest.fixture(scope="module")
def setup():
    keys, q = manifold(0, N_CTX, HD, NQ)
    values = np.random.default_rng(1).standard_normal((N_CTX, HD)).astype(np.float32)
    return keys, values, q


@pytest.fixture(scope="module")
def jax_memory(setup):
    keys, values, _ = setup
    return JaxKNNMemory.build(keys, values, n_partitions=64, spill_mode="soar")


def twins(jax_memory, engine):
    """(a JAX KNNMemory, its port twin on the CPU), equal bit for bit."""
    jm = JaxKNNMemory(**{f: getattr(jax_memory, f) for f in ("index", "values",
                                                          "segments", "top_t")},
                      engine=engine)
    jm.index = type(jm.index).from_index(jm.index.to_ivf_index())
    jm.values, jm.segments = jm.values.copy(), jm.segments.copy()
    tm = convert.knn_memory_from_numpy(knn_fields(jm), device="cpu")
    assert_same_memory(jm, tm)
    return jm, tm


def script(mem, rng_seed=5):
    """The mutation script both packages run: adds labelled per row and
    per batch, a hard and a soft eviction."""
    rng = np.random.default_rng(rng_seed)
    K = rng.standard_normal((300, HD)).astype(np.float32)
    V = rng.standard_normal((300, HD)).astype(np.float32)
    a = mem.add(K[:200], V[:200], segment=np.repeat(np.arange(4), 50))
    b = mem.add(K[200:], V[200:], segment=7)
    mem.remove(np.arange(0, 400, 5))
    mem.remove(np.arange(1, 400, 11), hard=False)
    return np.concatenate([a, b])


@pytest.mark.parametrize("engine", ENGINES)
def test_retrieval_matches_jax(jax_memory, setup, engine):
    """Both packages through one script, then the same retrievals (plain,
    recency window, segment, raw mask, combined): ids on >= 0.995 of
    slots, keys and values gathered by id equal; attend within tolerance
    on the rows whose ids agree."""
    _, _, q = setup
    jm, tm = twins(jax_memory, engine)
    np.testing.assert_array_equal(script(tm), script(jm))
    assert_same_memory(jm, tm)
    mask = (np.arange(jm.index.n_total) % 3 > 0).astype(np.uint8)
    for kw in (dict(), dict(top_t=4), dict(recency=5_000), dict(segment=7),
               dict(segment=2, recency=250), dict(filter_mask=mask),
               dict(segment=0, escalate=False)):
        ji, jK, jV = jm.retrieve(q, k=12, **kw)
        ti, tK, tV = tm.retrieve(q, k=12, **kw)
        assert float((ji == ti).mean()) >= 0.995, kw
        same = ji == ti
        np.testing.assert_array_equal(tK[same], jK[same])
        np.testing.assert_array_equal(tV[same], jV[same])
        jo, jids = jm.attend(q, k=12, **kw)
        to, tids = tm.attend(q, k=12, **kw)
        rows = (jids == tids).all(1)
        assert rows.mean() >= 0.95, kw
        np.testing.assert_allclose(to[rows], jo[rows], rtol=1e-4, atol=1e-5)
        assert to.dtype == np.float32
    r = tm.retrieve_request(q, SearchParams(k=5, segment=7))[0]
    assert (r.scores is None) == (engine == "numpy")
    assert r.epoch == jm.index._alive_epoch


def test_exact_topk_attention_matches_jax(setup):
    keys, values, q = setup
    jo, jids = jax_exact_topk_attention(q, keys, values, k=16)
    to, tids = exact_topk_attention(q, keys, values, k=16, device="cpu")
    np.testing.assert_allclose(to, jo, rtol=1e-4, atol=1e-5)
    assert all(set(a) == set(b) for a, b in zip(tids.tolist(), jids.tolist()))
    # tensors in: the work stays on their device
    to2, tids2 = exact_topk_attention(torch.from_numpy(q), torch.from_numpy(keys),
                                      torch.from_numpy(values), k=16)
    np.testing.assert_array_equal(to2, to)
    np.testing.assert_array_equal(tids2, tids)


@pytest.mark.parametrize("engine", ENGINES)
def test_state_lives_on_the_index_device(setup, engine):
    """values, segments and the keys view are tensors on the index's
    device; adds grow them geometrically and label each row."""
    keys, values, _ = setup
    mem = KNNMemory.build(keys[:2000], values[:2000], n_partitions=16,
                          engine=engine, segment=np.arange(2000) % 3, device="cpu")
    assert mem.values.device == mem.segments.device == mem.index.device
    assert mem.keys.data_ptr() == mem.index.rerank.data_ptr()
    ids = mem.add(keys[2000:2010], values[2000:2010], segment=9)
    assert ids.dtype == np.int32 and ids.tolist() == list(range(2000, 2010))
    assert mem.values.shape[0] == 4000 and mem.segments.shape[0] == 4000
    assert mem.segments[2000:2010].tolist() == [9] * 10
    assert int(mem.segments[2010]) == -1 and int(mem.segments[5]) == 2
    got, _, V = mem.retrieve(keys[2000:2010], k=3, segment=9)
    assert set(got[got >= 0].tolist()) <= set(ids.tolist())
    np.testing.assert_array_equal(V[got >= 0], values[got[got >= 0]])


@pytest.mark.parametrize("engine", ENGINES)
def test_knn_attention_close_to_exact(setup, engine):
    keys, values, q = setup
    mem = KNNMemory.build(keys, values, n_partitions=64, spill_mode="soar",
                          engine=engine, device="cpu")
    out, ids = mem.attend(q, k=16, top_t=8)
    exact_out, exact_ids = exact_topk_attention(q, keys, values, k=16, device="cpu")
    key_recall = (ids[:, :, None] == exact_ids[:, None, :]).any(-1).mean()
    assert key_recall > 0.85, key_recall
    rel = np.linalg.norm(out - exact_out, axis=1) / np.maximum(
        np.linalg.norm(exact_out, axis=1), 1e-9)
    assert np.mean(rel) < 0.15, np.mean(rel)


def test_soar_beats_no_spill_at_fixed_probes(setup):
    keys, values, q = setup
    rec = {}
    _, exact_ids = exact_topk_attention(q, keys, values, k=16, device="cpu")
    for mode in ("none", "soar"):
        mem = KNNMemory.build(keys, values, n_partitions=64, spill_mode=mode,
                              device="cpu")
        ids, _, _ = mem.retrieve(q, k=16, top_t=2)   # tight probe budget
        rec[mode] = (ids[:, :, None] == exact_ids[:, None, :]).any(-1).mean()
    assert rec["soar"] >= rec["none"] - 0.02, rec


@pytest.mark.parametrize("engine", ENGINES)
def test_full_eviction_attends_to_nothing(setup, engine):
    """After every position is evicted, retrieval returns -1 everywhere and
    attend a zero output (not a mix of row 0)."""
    keys, values, q = setup
    mem = KNNMemory.build(keys[:1000], values[:1000], n_partitions=8,
                          engine=engine, device="cpu")
    mem.remove(np.arange(1000), hard=False)
    out, ids = mem.attend(q[:4], k=5)
    assert (ids == -1).all() and not out.any()


def test_build_runs_on_the_card_unless_asked(setup):
    keys, values, _ = setup
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            KNNMemory.build(keys[:500], values[:500], n_partitions=4)
    mem = KNNMemory.build(keys[:500], values[:500], n_partitions=4, device="cpu")
    assert mem.index.device.type == "cpu"


# ---------------------------------------------- tests/test_serve_api.py
@pytest.fixture(scope="module", params=ENGINES)
def memory(request, setup):
    keys, values, _ = setup
    return KNNMemory.build(keys[:3000], values[:3000], n_partitions=16,
                           engine=request.param, device="cpu")


def test_memory_shim_parity(memory):
    rng = np.random.default_rng(3)
    q = rng.normal(size=(5, HD)).astype(np.float32)
    ids_a, K_a, V_a = memory.retrieve(q, k=9, top_t=5, recency=1000)
    r, K_b, V_b = memory.retrieve_request(q, SearchParams(k=9, top_t=5, recency=1000))
    assert np.array_equal(ids_a, r.ids)
    assert np.array_equal(K_a, K_b) and np.array_equal(V_a, V_b)


def test_validation_is_shared(memory):
    q = np.random.default_rng(2).normal(size=(2, HD)).astype(np.float32)
    with pytest.raises(ValueError):
        memory.retrieve(q, k=0)
    with pytest.raises(ValueError):
        memory.retrieve(q, top_t=0)          # explicit 0 raises, never falls back
    with pytest.raises(ValueError):
        memory.retrieve(q, k=True)
    bad = q.copy()
    bad[0, 0] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        memory.retrieve(bad, k=3)


def test_default_top_t_unified(memory):
    """KNNMemory's default probe budget is the serving default — the same
    constant AnnEngine uses."""
    assert memory.top_t == DEFAULT_TOP_T
    assert AnnEngine(memory.index).top_t == DEFAULT_TOP_T
    q = np.random.default_rng(4).normal(size=(4, HD)).astype(np.float32)
    ids_default, _, _ = memory.retrieve(q, k=6)
    ids_explicit, _, _ = memory.retrieve(q, k=6, top_t=DEFAULT_TOP_T)
    assert np.array_equal(ids_default, ids_explicit)


def test_memory_top_t_round_trips(tmp_path, setup):
    keys, values, _ = setup
    mem = KNNMemory.build(keys[:3000], values[:3000], n_partitions=16,
                          engine="numpy", device="cpu")
    mem.top_t = 13
    mem.save(str(tmp_path / "mem"))
    back = KNNMemory.open(str(tmp_path / "mem"), device="cpu")
    assert back.top_t == 13
    q = np.random.default_rng(5).normal(size=(3, HD)).astype(np.float32)
    a, _, _ = mem.retrieve(q, k=5)
    b, _, _ = back.retrieve(q, k=5)
    assert np.array_equal(a, b)
