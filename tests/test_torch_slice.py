"""The port's build + search slice (repro_torch) against the JAX package on
the same data: frozen-seam build, search of one converted index, free
builds with each package's own random stream, and per-module parity of
the pieces the slice is made of. Runs on the CPU at n=20k, d=32, c=64,
m=8; tests/test_torch_cuda.py repeats the slice on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ivf as jax_ivf  # noqa: E402
from repro.core import search as jax_search  # noqa: E402
from repro.core.build import build_ivf_sharded as jax_build  # noqa: E402
from repro.core.kmeans import kmeans_pp_init as jax_pp_init  # noqa: E402
from repro.core.kmr import true_neighbors as jax_true_neighbors  # noqa: E402
from repro.core.soar import soar_assign as jax_soar_assign  # noqa: E402
from repro.kernels.lloyd import lloyd_sweep_batched as jax_sweep_batched  # noqa: E402
from repro.quant import pq as jax_pq  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import build_ivf_sharded, pack_ivf, search_jit_batched  # noqa: E402
from repro_torch.core import ivf, search  # noqa: E402
from repro_torch.core.kmeans import kmeans_pp_init, train_kmeans  # noqa: E402
from repro_torch.core.kmr import recall_at_k, true_neighbors  # noqa: E402
from repro_torch.core.soar import naive_spill_assign, soar_assign  # noqa: E402
from repro_torch.data.vectors import make_manifold  # noqa: E402
from repro_torch.kernels.lloyd import lloyd_sweep_batched  # noqa: E402
from repro_torch.quant import pq  # noqa: E402

from torch_recall import assert_recall_means_close  # noqa: E402

N, D, C, M, NQ = 20_000, 32, 64, 8, 200
TOP_T, K, BUDGET, BQ = 8, 10, 64, 64


def _t(a, device="cpu"):
    return torch.from_numpy(np.array(a)).to(device)


def _fields(idx):
    """A JAX IVFIndex as the numpy fields convert.index_from_numpy takes."""
    return {"centroids": np.asarray(idx.centroids), "starts": idx.starts,
            "point_ids": idx.point_ids, "codes": idx.codes,
            "pq.centers": None if idx.pq is None else np.asarray(idx.pq.centers),
            "rerank_f32": idx.rerank_f32, "assignments": idx.assignments,
            "n_points": idx.n_points, "spill_mode": idx.spill_mode,
            "lam": idx.lam}


def _recall(ids, gt):
    return recall_at_k(_t(np.asarray(ids)), _t(np.asarray(gt)), K)


@pytest.fixture(scope="module")
def data():
    ds = make_manifold(0, N, D, nq=NQ, device="cpu")
    return ds.X.numpy(), ds.Q.numpy()


@pytest.fixture(scope="module")
def gt(data):
    X, Q = data
    return np.asarray(jax_true_neighbors(X, Q, k=K))


@pytest.fixture(scope="module")
def jax_index(data):
    return jax_build(jax.random.PRNGKey(0), data[0], C, spill_mode="soar",
                     lam=1.0, pq_subspaces=M)


@pytest.fixture(scope="module")
def jax_results(jax_index, data):
    packed = jax_search.pack_ivf(jax_index, pair_codes=False)
    ids, scores = jax_search.search_jit_batched(
        packed, jnp.asarray(data[1]), top_t=TOP_T, final_k=K,
        rerank_budget=BUDGET, bq=BQ)
    return np.asarray(ids), np.asarray(scores)


# ------------------------------------------------------------ frozen seam
@pytest.mark.parametrize("spill_mode", ["none", "naive", "soar"])
def test_frozen_seam_build_matches_jax(jax_index, data, spill_mode):
    X = data[0]
    cb, pqc = np.asarray(jax_index.centroids), jax_index.pq
    want = jax_build(None, X, C, spill_mode=spill_mode, lam=1.0,
                     codebook=cb, pq=pqc)
    got = build_ivf_sharded(None, X, C, spill_mode=spill_mode, lam=1.0,
                            codebook=cb, pq=pq.PQCodebook(_t(np.asarray(pqc.centers))),
                            device="cpu")
    ga, wa = got.assignments.numpy(), want.assignments
    assert ga.shape == wa.shape
    assert (ga == wa).all(axis=1).mean() >= 0.999
    if (ga == wa).all():
        np.testing.assert_array_equal(got.starts.numpy(), want.starts)
        np.testing.assert_array_equal(got.point_ids.numpy(), want.point_ids)
        assert (got.codes.numpy() == want.codes).mean() >= 0.999


def test_csr_is_the_counting_sort(jax_index):
    a = jax_index.assignments
    starts, pids, order = ivf._csr_from_assignments(_t(a), C)
    wstarts, wpids, worder = jax_ivf._csr_from_assignments(a, C)
    np.testing.assert_array_equal(starts.numpy(), wstarts)
    np.testing.assert_array_equal(pids.numpy(), wpids)
    np.testing.assert_array_equal(order.numpy(), worder)


# ------------------------------------------------------------------ search
def test_search_converted_index_matches_jax(jax_index, jax_results, data, gt):
    idx = convert.index_from_numpy(_fields(jax_index), device="cpu")
    ids, scores = search_jit_batched(pack_ivf(idx), data[1], top_t=TOP_T,
                                     final_k=K, rerank_budget=BUDGET, bq=BQ)
    ids, scores = ids.numpy(), scores.numpy()
    wids, wscores = jax_results
    same = ids == wids
    assert same.mean() >= 0.995
    np.testing.assert_allclose(scores[same], wscores[same], rtol=1e-5)
    assert abs(_recall(ids, gt) - _recall(wids, gt)) <= 0.005


@pytest.mark.parametrize("pmax", [None, 0, 300])
def test_pack_matches_jax(jax_index, pmax):
    packed = pack_ivf(convert.index_from_numpy(_fields(jax_index), device="cpu"),
                      pmax=pmax)
    want = jax_search.pack_ivf(jax_index, pmax=pmax, pair_codes=False)
    np.testing.assert_array_equal(packed.part_ids.numpy(), np.asarray(want.part_ids))
    np.testing.assert_array_equal(packed.part_codes.numpy(),
                                  np.asarray(want.part_codes))
    np.testing.assert_array_equal(packed.sizes.numpy(), np.asarray(want.sizes))


def test_exact_window_search_matches_jax(data, gt):
    """No PQ stage: the whole window is scored exactly (search.py:411-424)."""
    X, Q = data
    idx = jax_build(jax.random.PRNGKey(1), X, C, spill_mode="naive")
    want, _ = jax_search.search_jit_batched(jax_search.pack_ivf(idx), jnp.asarray(Q),
                                            top_t=TOP_T, final_k=K, bq=BQ)
    got, _ = search_jit_batched(pack_ivf(convert.index_from_numpy(
        _fields(idx), device="cpu")), Q, top_t=TOP_T, final_k=K, bq=BQ)
    assert (got.numpy() == np.asarray(want)).mean() >= 0.995


@pytest.mark.parametrize("k,mult", [(4, 2), (10, 2), (40, 1)])
def test_dedup_topk_window_matches_jax(k, mult):
    rng = np.random.default_rng(k)
    ids = rng.integers(-1, 30, (6, 48)).astype(np.int32)
    scores = rng.standard_normal((6, 48)).astype(np.float32)
    wi, wv = jax_search.dedup_topk_window(jnp.asarray(ids), jnp.asarray(scores), k, mult)
    gi, gv = search.dedup_topk_window(_t(ids), _t(scores), k, mult)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    fin = np.isfinite(np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy()[fin], np.asarray(wi)[fin])


@pytest.mark.parametrize("nq,cap,multiple", [(1, 128, 1), (13, 128, 1),
                                             (300, 128, 1), (5, 64, 3)])
def test_query_bucket_padding_matches_jax(nq, cap, multiple):
    Q = np.ones((nq, 4), np.float32)
    got, want = search.pad_queries(Q, cap, multiple), jax_search.pad_queries(Q, cap, multiple)
    assert got[1:] == want[1:] and got[0].shape == want[0].shape
    assert search.bq_bucket(nq, cap) == jax_search.bq_bucket(nq, cap)


def test_entry_points_never_fall_back_to_cpu():
    """Without a card, an entry point called without device= raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_manifold(0, 10, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_ivf_sharded(None, np.zeros((10, 4), np.float32), 2)


def test_true_neighbors_match_jax(data, gt):
    X, Q = data
    got = true_neighbors(_t(X), _t(Q), k=K, chunk=4096).numpy()
    assert (got == gt).mean() >= 0.999


# --------------------------------------------------------------- free build
def test_free_build_recall_close_to_jax(data, gt):
    """Each package's own random stream: the mean recall@10 over seeds 0-3
    within 0.02 of JAX's (tests/torch_recall.py)."""
    X, Q = data
    kw = dict(spill_mode="soar", lam=1.0, pq_subspaces=M)

    def port(seed):
        idx = build_ivf_sharded(torch.Generator().manual_seed(seed), X, C, device="cpu",
                                **kw)
        ids, _ = search_jit_batched(pack_ivf(idx), Q, top_t=TOP_T, final_k=K,
                                    rerank_budget=BUDGET, bq=BQ)
        return _recall(ids.numpy(), gt)

    def ref(seed):
        packed = jax_search.pack_ivf(jax_build(jax.random.PRNGKey(seed), X, C, **kw),
                                     pair_codes=False)
        ids, _ = jax_search.search_jit_batched(packed, jnp.asarray(Q), top_t=TOP_T,
                                               final_k=K, rerank_budget=BUDGET, bq=BQ)
        return _recall(ids, gt)

    assert_recall_means_close(port, ref)


# ------------------------------------------------------- module pieces
def test_pq_encode_and_lut_match_jax(jax_index, data):
    centers = np.asarray(jax_index.pq.centers)
    cb = pq.PQCodebook(_t(centers))
    X, Q = data
    res = X[:5000] - np.asarray(jax_index.centroids)[jax_index.assignments[:5000, 0]]
    want = np.asarray(jax_pq.pq_encode(jax_index.pq, jnp.asarray(res)))
    assert (pq.pq_encode(cb, _t(res)).numpy() == want).mean() >= 0.999
    wl = np.asarray(jax.vmap(lambda q: jax_pq.pq_lut(jax_index.pq, q))(jnp.asarray(Q)))
    np.testing.assert_allclose(pq.pq_lut(cb, _t(Q)).numpy(), wl, rtol=1e-5, atol=1e-6)


def test_lloyd_sweep_batched_matches_jax(data):
    X = data[0][:6000]
    Xm = np.ascontiguousarray(X.reshape(6000, M, D // M).transpose(1, 0, 2))
    Cm = np.ascontiguousarray(Xm[:, :16] + 0.01)
    wC, wcnt, wd = jax_sweep_batched(jnp.asarray(Xm), jnp.asarray(Cm), 16, chunk=2048)
    gC, gcnt, gd = lloyd_sweep_batched(_t(Xm), _t(Cm), chunk=2048)
    np.testing.assert_array_equal(gcnt.numpy(), np.asarray(wcnt))
    np.testing.assert_allclose(gC.numpy(), np.asarray(wC), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5)


def test_train_pq_quality_close_to_jax(data):
    """Different random streams: compare the reconstruction error reached."""
    res = data[0][:8000]

    def err(centers, codes):
        rec = np.take_along_axis(centers[None], codes[:, :, None, None].astype(np.int64),
                                 axis=2)[:, :, 0, :].reshape(len(res), -1)
        return float(((res - rec) ** 2).sum(-1).mean())

    jcb = jax_pq.train_pq(jax.random.PRNGKey(3), jnp.asarray(res), M)
    gcb = pq.train_pq(torch.Generator().manual_seed(3), _t(res), M)
    je = err(np.asarray(jcb.centers), np.asarray(jax_pq.pq_encode(jcb, jnp.asarray(res))))
    ge = err(gcb.centers.numpy(), pq.pq_encode(gcb, _t(res)).numpy())
    assert ge <= 1.05 * je


def test_kmeans_quality_close_to_jax(data):
    from repro.core.kmeans import train_kmeans as jax_train_kmeans
    X = data[0][:10000]
    jd = float(jax_train_kmeans(jax.random.PRNGKey(5), X, C, iters=10).distortion)
    gd = float(train_kmeans(torch.Generator().manual_seed(5), _t(X), C, iters=10).distortion)
    assert gd <= 1.05 * jd


def test_kmeans_pp_init_picks_data_rows(data):
    X = data[0][:3000]
    cents = kmeans_pp_init(torch.Generator().manual_seed(0), _t(X), 32).numpy()
    rows = {r.tobytes() for r in X}
    assert all(c.tobytes() in rows for c in cents)
    assert len({c.tobytes() for c in cents}) == 32
    jc = np.asarray(jax_pp_init(jax.random.PRNGKey(0), jnp.asarray(X), 32))
    assert all(c.tobytes() in rows for c in jc)


@pytest.mark.parametrize("lam", [0.0, 1.0, 1.5])
def test_soar_compositions_match_jax(jax_index, data, lam):
    X = data[0][:4000]
    cb = np.asarray(jax_index.centroids)
    prim = jax_index.assignments[:4000, 0]
    want = np.asarray(jax_soar_assign(jnp.asarray(X), jnp.asarray(cb),
                                      jnp.asarray(prim), lam=lam))
    fn = naive_spill_assign if lam == 0.0 else (
        lambda x, c, p: soar_assign(x, c, p, lam=lam))
    got = fn(_t(X), _t(cb), _t(prim)).numpy()
    assert (got == want).mean() >= 0.999
