"""The port's served int8 index (repro_torch): an index built with
`rerank="int8"` keeps its rows as (n, d) int8 codes and (n,) f32 scales
through `MutableIVF`, `PackedIVF`, the search, the snapshot store and the
log, with no (n, d) f32 copy of them.

The port scores a candidate ⟨q, x₈⟩ summed in f32 times the row's scale;
the JAX package dequantizes its rows first and scores ⟨q, x₈·s⟩. That
departure is pinned against the JAX package: the same ids wherever the
scores are not within f32 rounding of a tie, and scores within 1e-6 of
each other, relatively. The shard-parallel search and the kNN memory keep
f32 rows (int8 rows dequantized at their entry). Runs on the CPU at
n <= 8,000, d = 24, c = 32, m = 8; tests/test_torch_cuda.py holds the
kernel against its plain version on the card.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import search as jax_search  # noqa: E402
from repro.core.build import build_ivf_sharded as jax_build  # noqa: E402
from repro.quant import int8 as jax_int8  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.ckpt.index_store import load_snapshot, save_snapshot  # noqa: E402
from repro_torch.core import pack_ivf, search_jit_batched, search_numpy  # noqa: E402
from repro_torch.core.build import build_ivf_sharded  # noqa: E402
from repro_torch.core.distributed import sharded_from_indexes  # noqa: E402
from repro_torch.core.mutable import MutableIVF  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.int8_rerank import int8_rerank  # noqa: E402
from repro_torch.quant.int8 import Int8Data, int8_dequantize, int8_quantize  # noqa: E402
from repro_torch.serve.api import SearchParams  # noqa: E402
from repro_torch.serve.engine import AnnEngine  # noqa: E402
from repro_torch.serve.knn_memory import KNNMemory  # noqa: E402

N, D, NQ, C, M = 8000, 24, 48, 32, 8
KW = dict(top_t=8, final_k=10, rerank_budget=96, bq=16, multiplicity=3)
BUILD = dict(spill_mode="soar", lam=1.0, n_spills=2, pq_subspaces=M, rerank="int8",
             train_sample=4096, shard_size=2048)
RTOL = 1e-6                     # the departure: one more f32 rounding a score


def manifold(seed, n, d, nq, p=6, hidden=64):
    """Unit vectors on a p-dimensional manifold, made by numpy → (X, Q)."""
    rng = np.random.default_rng(seed)
    W1 = rng.standard_normal((p, hidden))
    W2 = rng.standard_normal((hidden, d)) / np.sqrt(hidden)
    Y = np.tanh(2.0 * rng.standard_normal((n + nq, p)) @ W1 / np.sqrt(p)) @ W2
    Y = (Y / np.linalg.norm(Y, axis=1, keepdims=True)).astype(np.float32)
    return Y[:n], Y[n:]


@pytest.fixture(scope="module")
def data():
    return manifold(4, N, D, NQ)


@pytest.fixture(scope="module")
def built(data):
    """The port's int8 index over the first 6,000 rows (two SOAR spills)."""
    return build_ivf_sharded(torch.Generator().manual_seed(3), data[0][:6000], C,
                             device="cpu", **BUILD)


def fresh(built) -> MutableIVF:
    return MutableIVF.from_index(built)


def f32_tables(obj, n: int, d: int):
    """Every (≥ n, d) float32 tensor among an object's fields."""
    vals = (obj if isinstance(obj, tuple) else
            [getattr(obj, f.name) for f in dataclasses.fields(obj)])
    out = []
    for v in vals:
        for t in (v if isinstance(v, tuple) else (v,)):
            if (isinstance(t, torch.Tensor) and t.dtype == torch.float32 and t.dim() == 2
                    and t.shape[0] >= n and t.shape[1] == d):
                out.append(t)
    return out


def assert_ties_only(ids_a, s_a, ids_b, s_b):
    """Ranks < k of two (nq, k + 1) answers: scores within RTOL of each
    other, and the same id at every rank whose score is not within f32
    rounding of a neighbour's (the (k+1)-th included)."""
    ids_a, ids_b = np.asarray(ids_a), np.asarray(ids_b)
    s_a, s_b = np.asarray(s_a, np.float64), np.asarray(s_b, np.float64)
    k = s_a.shape[1] - 1
    np.testing.assert_allclose(s_a[:, :k], s_b[:, :k], rtol=RTOL, atol=0)
    tol = 4 * np.finfo(np.float32).eps * np.abs(s_a)
    near = np.zeros(s_a.shape, bool)
    near[:, 1:] |= np.abs(s_a[:, 1:] - s_a[:, :-1]) <= tol[:, 1:]
    near[:, :-1] |= np.abs(s_a[:, :-1] - s_a[:, 1:]) <= tol[:, :-1]
    clear = ~near[:, :k]
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(ids_a[:, :k][clear], ids_b[:, :k][clear])


# --------------------------------------------------------------- departure
def test_rerank_departs_from_jax_by_one_rounding(data):
    """The same candidates reranked both ways: the port's plain rerank
    (the kernel's function) against JAX's ⟨q, x₈·s⟩ and `lax.top_k`."""
    X, Q = data
    q8 = jax_int8.int8_quantize(jnp.asarray(X))
    rng = np.random.default_rng(0)
    B, k = 96, 10
    ids = rng.integers(0, N, (NQ, B)).astype(np.int32)
    approx = rng.standard_normal((NQ, B)).astype(np.float32)
    approx[:, -7:] = -np.inf                               # dedup's dropped slots
    deq = np.asarray(jax_int8.int8_dequantize(q8))
    want = np.einsum("qbd,qd->qb", deq[ids], Q)
    want = np.where(np.isfinite(approx), want, -np.inf).astype(np.float32)
    wv, wpos = jax.lax.top_k(jnp.asarray(want), k + 1)
    wi = np.take_along_axis(ids, np.asarray(wpos), 1)
    rows = Int8Data(torch.from_numpy(np.array(q8.q)), torch.from_numpy(np.array(q8.scale)))
    gi, gv = int8_rerank(torch.from_numpy(Q), rows, torch.from_numpy(ids),
                         torch.from_numpy(approx), k + 1)
    assert_ties_only(gi, gv, wi, wv)


def test_search_departs_from_jax_by_one_rounding(data):
    """A JAX-built int8 index carried across: the port's search over the
    int8 rows against JAX's over its dequantized table."""
    X, Q = data
    jidx = jax_build(jax.random.PRNGKey(0), X[:6000], C, **BUILD)
    f = {"centroids": np.asarray(jidx.centroids), "starts": jidx.starts,
         "point_ids": jidx.point_ids, "codes": jidx.codes,
         "pq.centers": np.asarray(jidx.pq.centers), "rerank_f32": None,
         "rerank_int8.q": np.asarray(jidx.rerank_int8.q),
         "rerank_int8.scale": np.asarray(jidx.rerank_int8.scale),
         "assignments": jidx.assignments, "n_points": jidx.n_points,
         "spill_mode": jidx.spill_mode, "lam": jidx.lam}
    packed = pack_ivf(convert.index_from_numpy(f, device="cpu"))
    assert isinstance(packed.rerank, Int8Data)
    kw = dict(KW, final_k=11)
    gi, gv = search_jit_batched(packed, Q, **kw)
    wi, wv = jax_search.search_jit_batched(jax_search.pack_ivf(jidx, pair_codes=False),
                                           jnp.asarray(Q), **kw)
    assert_ties_only(gi, gv, wi, wv)


def test_rerank_wrapper_on_the_cpu_is_the_plain_version(data, built):
    X, Q = data
    rows = built.rerank_int8
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(-1, 6000, (NQ, 40)).astype(np.int32))
    approx = torch.where(ids >= 0, torch.randn(NQ, 40), float("-inf"))
    n0 = int8_rerank.launches
    for k in (10, 40, 50):
        got = int8_rerank(torch.from_numpy(Q), rows, ids, approx, k)
        want = ref.int8_rerank_ref(torch.from_numpy(Q), rows.q, rows.scale, ids, approx, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int8_rerank.launches == n0
    assert bool((got[0][:, 40:] == -1).all()) and bool(torch.isneginf(got[1][:, 40:]).all())
    s = ref.int8_scores_ref(torch.from_numpy(Q), rows.q, rows.scale, ids.clamp(min=0))
    deq = int8_dequantize(rows)[ids.clamp(min=0).long()]
    torch.testing.assert_close(s, torch.einsum("qbd,qd->qb", deq, torch.from_numpy(Q)),
                               rtol=RTOL, atol=1e-7)


# --------------------------------------------------------- the served index
def test_the_served_index_holds_int8_rows_and_no_f32_table(built, data):
    mut = fresh(built)
    assert isinstance(mut.rerank, Int8Data)
    assert mut.rerank.q.dtype == torch.int8 and mut.rerank.scale.dtype == torch.float32
    assert torch.equal(mut.rerank.q, built.rerank_int8.q)
    assert torch.equal(mut.rerank.scale, built.rerank_int8.scale)
    packed = mut.pack()
    assert packed.rerank.q.data_ptr() == mut.rerank.q.data_ptr()
    assert packed.rerank.scale.data_ptr() == mut.rerank.scale.data_ptr()
    assert f32_tables(mut, 6000, D) == [] and f32_tables(packed, 6000, D) == []
    mut.add(data[0][6000:6500])
    assert f32_tables(mut, 6000, D) == [] and f32_tables(mut.pack(), 6000, D) == []
    csr = mut.to_ivf_index()
    assert csr.rerank_f32 is None and csr.rerank_int8.q.shape == (6500, D)


def test_pack_ivf_keeps_the_int8_rows(built, data):
    """The int8 pack searches as the pack of its dequantized rows, to one
    rounding a score."""
    packed = pack_ivf(built)
    assert packed.rerank.q.data_ptr() == built.rerank_int8.q.data_ptr()
    deq = packed._replace(rerank=int8_dequantize(built.rerank_int8))
    kw = dict(KW, final_k=11)
    ids, vals = search_jit_batched(packed, data[1], **kw)
    assert bool((ids >= 0).all())
    assert_ties_only(ids, vals, *search_jit_batched(deq, data[1], **kw))


def test_add_quantizes_the_new_rows(built, data):
    mut = fresh(built)
    new = mut.add(data[0][6000:7000])
    want = int8_quantize(torch.from_numpy(data[0][6000:7000]))
    assert torch.equal(mut.rerank.q[new.long()], want.q)
    assert torch.equal(mut.rerank.scale[new.long()], want.scale)
    assert torch.equal(mut.rerank.q[:6000], built.rerank_int8.q)
    ids, _ = search_jit_batched(mut.pack(), data[0][6000:7000], **KW)
    assert (ids[:, 0] == new).float().mean() > 0.95


def test_remove_and_compaction_keep_the_rows(built, data):
    mut = fresh(built)
    mut.add(data[0][6000:6400])
    q0, s0 = mut.rerank.q.clone(), mut.rerank.scale.clone()
    gone = np.arange(0, 2400)                      # past the compaction threshold
    assert mut.remove(gone) == gone.size and mut.n_dead_slots == 0
    soft = np.arange(1, 600, 4)
    mut.remove(soft, hard=False)
    assert torch.equal(mut.rerank.q, q0) and torch.equal(mut.rerank.scale, s0)
    mut.compact()
    ids, vals = search_jit_batched(mut.pack(), data[1], **KW, filter=mut.standing_filter())
    assert not np.isin(ids.numpy(), np.concatenate([gone, soft])).any()
    ref_ids, _ = search_numpy(mut.to_ivf_index(), data[1], top_t=8, final_k=10,
                              rerank_budget=96, filter_mask=mut.alive.to(torch.uint8))
    assert (ids.numpy() == ref_ids.numpy()).mean() > 0.97


def test_the_host_engine_scores_the_int8_rows(built, data):
    X, Q = data
    ids, _ = search_numpy(built, Q, top_t=8, final_k=11, rerank_budget=0)
    deq = dataclasses.replace(built, rerank_int8=None,
                              rerank_f32=int8_dequantize(built.rerank_int8))
    want, _ = search_numpy(deq, Q, top_t=8, final_k=11, rerank_budget=0)
    assert (ids[:, :10] == want[:, :10]).float().mean() > 0.99


def test_rebuild_reference_dequantizes_the_live_rows(built, data):
    mut = fresh(built)
    mut.add(data[0][6000:6300])
    mut.remove(np.arange(0, 600, 3))
    live = torch.nonzero(mut.alive[:mut.n_total])[:, 0]
    rb = mut.rebuild_reference()
    assert rb.rerank_int8 is None
    assert torch.equal(rb.rerank_f32,
                       int8_dequantize(Int8Data(mut.rerank.q[live], mut.rerank.scale[live])))


@pytest.mark.parametrize("kind", ["mutable", "packed"])
def test_the_store_round_trips_the_int8_rows(built, data, tmp_path, kind):
    mut = fresh(built)
    mut.add(data[0][6000:6300])
    mut.remove(np.arange(0, 300, 5))
    obj = mut if kind == "mutable" else mut.pack()
    save_snapshot(str(tmp_path / "s"), obj)
    back, _ = load_snapshot(str(tmp_path / "s"), device="cpu")
    assert isinstance(back.rerank, Int8Data)
    assert torch.equal(back.rerank.q, obj.rerank.q)
    assert torch.equal(back.rerank.scale, obj.rerank.scale)
    packed = back.pack() if kind == "mutable" else back
    a = search_jit_batched(packed, data[1], **KW)
    b = search_jit_batched(obj.pack() if kind == "mutable" else obj, data[1], **KW)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_the_log_replays_onto_int8_rows(built, data, tmp_path):
    eng = AnnEngine(fresh(built), top_t=8, rerank_budget=96, bq=16)
    path = str(tmp_path / "eng")
    eng.save(path)
    live = AnnEngine.open(path, wal=True, device="cpu")
    live.add(data[0][6000:6200])
    live.remove(np.arange(0, 1800, 2))
    live.remove(np.arange(1, 300, 2), hard=False)
    live.add(data[0][6200:6300])
    again = AnnEngine.open(path, device="cpu")
    a, b = live.index, again.index
    assert torch.equal(a.rerank.q, b.rerank.q) and torch.equal(a.rerank.scale, b.rerank.scale)
    assert torch.equal(a.part_ids, b.part_ids) and torch.equal(a.alive, b.alive)
    want = int8_quantize(torch.from_numpy(data[0][6200:6300]))
    assert torch.equal(b.rerank.q[6200:6300], want.q)
    ra = live.search_request(data[1], SearchParams(k=10))
    rb = again.search_request(data[1], SearchParams(k=10))
    assert np.array_equal(ra.ids, rb.ids) and ra.scores.tobytes() == rb.scores.tobytes()


def test_a_filtered_budget_search_over_int8_rows(built, data):
    mut = fresh(built)
    bits = np.zeros(6000, np.uint8)
    bits[::40] = 1
    eng = AnnEngine(mut, top_t=8, rerank_budget=96, bq=16)
    r = eng.search_request(data[1], SearchParams(k=10, filter_mask=bits, escalate="budget"))
    assert (r.ids >= 0).all() and bits[r.ids].all()


# ------------------------------------------- the paths that keep f32 rows
def test_the_shard_stack_dequantizes_int8_rows(data):
    X = data[0]
    shards = [build_ivf_sharded(torch.Generator().manual_seed(s), X[s * 3000:(s + 1) * 3000],
                                16, device="cpu", **dict(BUILD, n_spills=1))
              for s in range(2)]
    sh = sharded_from_indexes(shards)
    assert sh.rerank.dtype == torch.float32 and sh.rerank.shape == (2, 3000, D)
    for s, idx in enumerate(shards):
        assert torch.equal(sh.rerank[s], int8_dequantize(idx.rerank_int8))
    f32 = [dataclasses.replace(i, rerank_int8=None, rerank_f32=int8_dequantize(i.rerank_int8))
           for i in shards]
    assert torch.equal(sharded_from_indexes(f32).rerank, sh.rerank)


def test_the_knn_memory_keeps_f32_keys(data):
    X = data[0][:2000]
    mem = KNNMemory.build(X, np.arange(2000, dtype=np.float32)[:, None], device="cpu")
    assert mem.keys.data_ptr() == mem.index.rerank.data_ptr()
    assert torch.equal(mem.keys, torch.from_numpy(X))
    idx = build_ivf_sharded(torch.Generator().manual_seed(0), X, 8, device="cpu",
                            rerank="int8")
    mem8 = KNNMemory(MutableIVF.from_index(idx), torch.zeros(2000, 1))
    assert torch.equal(mem8.keys, int8_dequantize(idx.rerank_int8))
