"""The rest of the port's build (repro_torch) against the JAX package on the
same data: multi-spill SOAR, anisotropic VQ, int8 rerank rows, the
flagged k-means modes, the PQ helpers, the synthetic sets and the
monolithic `build_ivf`; and the two search repairs (a mutable index's
tombstones inside a partition, the flat route's tie order). Runs on the
CPU at n <= 20k, d <= 32, c <= 64, inputs made by numpy from a seed;
tests/test_torch_cuda.py repeats the new paths on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ivf as jax_ivf  # noqa: E402
from repro.core import kmeans as jax_kmeans  # noqa: E402
from repro.core import search as jax_search  # noqa: E402
from repro.core import soar as jax_soar  # noqa: E402
from repro.core.build import build_ivf_sharded as jax_build  # noqa: E402
from repro.core.kmr import true_neighbors as jax_true_neighbors  # noqa: E402
from repro.core.mutable import MutableIVF  # noqa: E402
from repro.core.router import FlatRouter as JaxFlatRouter  # noqa: E402
from repro.data import vectors as jax_vectors  # noqa: E402
from repro.quant import anisotropic as jax_aniso  # noqa: E402
from repro.quant import int8 as jax_int8  # noqa: E402
from repro.quant import pq as jax_pq  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import build_ivf, build_ivf_sharded, pack_ivf  # noqa: E402
from repro_torch.core import finalize_ivf, search_jit_batched  # noqa: E402
from repro_torch.core import kmeans  # noqa: E402
from repro_torch.core.kmr import recall_at_k  # noqa: E402
from repro_torch.core.router import FlatRouter  # noqa: E402
from repro_torch.core.soar import soar_assign_multi, soar_loss_values  # noqa: E402
from repro_torch.data import vectors  # noqa: E402
from repro_torch.kernels.soar_assign import assign_fused  # noqa: E402
from repro_torch.quant import anisotropic as aniso  # noqa: E402
from repro_torch.quant import int8, pq  # noqa: E402

from torch_recall import assert_recall_means_close  # noqa: E402

N, D, C, M, NQ = 20_000, 32, 64, 8, 200
TOP_T, K, BUDGET, BQ = 8, 10, 64, 64
T_ANISO = 0.2


def _t(a):
    return torch.from_numpy(np.array(a))


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _agree(a, b):
    return float((np.asarray(a) == np.asarray(b)).mean())


def _fields(idx):
    """A JAX IVFIndex as the numpy fields convert.index_from_numpy takes."""
    f = {"centroids": np.asarray(idx.centroids), "starts": idx.starts,
         "point_ids": idx.point_ids, "codes": idx.codes,
         "pq.centers": None if idx.pq is None else np.asarray(idx.pq.centers),
         "rerank_f32": idx.rerank_f32, "assignments": idx.assignments,
         "n_points": idx.n_points, "spill_mode": idx.spill_mode, "lam": idx.lam}
    if idx.rerank_int8 is not None:
        f["rerank_int8.q"] = np.asarray(idx.rerank_int8.q)
        f["rerank_int8.scale"] = np.asarray(idx.rerank_int8.scale)
    return f


def _recall(ids, gt):
    return recall_at_k(_t(np.asarray(ids)), _t(np.asarray(gt)), K)


@pytest.fixture(scope="module")
def data():
    ds = vectors.make_manifold(0, N, D, nq=NQ, device="cpu")
    return ds.X.numpy(), ds.Q.numpy()


@pytest.fixture(scope="module")
def gt(data):
    X, Q = data
    return np.asarray(jax_true_neighbors(X, Q, k=K))


@pytest.fixture(scope="module")
def codebook(data):
    """A JAX-trained codebook (c=64) and primaries over the first 6,000 rows."""
    X = data[0][:6000]
    km = jax_kmeans.train_kmeans(jax.random.PRNGKey(2), X, C, iters=8)
    return X, np.asarray(km.centroids), np.asarray(km.assignments)


def _search_recall(idx, Q, gt):
    ids, _ = search_jit_batched(pack_ivf(idx), Q, top_t=TOP_T, final_k=K,
                                rerank_budget=BUDGET, bq=BQ)
    return _recall(ids.numpy(), gt)


def _jax_recall(idx, Q, gt):
    ids, _ = jax_search.search_jit_batched(
        jax_search.pack_ivf(idx, pair_codes=False), jnp.asarray(Q), top_t=TOP_T,
        final_k=K, rerank_budget=BUDGET, bq=BQ)
    return _recall(ids, gt)


# ------------------------------------------------------------ multi-spill
@pytest.mark.parametrize("n_spills,lam", [(2, 1.0), (3, 1.0), (2, 1.5)])
def test_soar_assign_multi_matches_jax(codebook, n_spills, lam):
    X, cb, prim = codebook
    want = np.asarray(jax_soar.soar_assign_multi(
        jnp.asarray(X), jnp.asarray(cb), jnp.asarray(prim), lam=lam, n_spills=n_spills))
    got = soar_assign_multi(_t(X), _t(cb), _t(prim), lam=lam, n_spills=n_spills).numpy()
    assert got.shape == want.shape == (len(X), 1 + n_spills)
    for j in range(1 + n_spills):                 # tolerance: 99.9% of rows a column
        assert _agree(got[:, j], want[:, j]) >= 0.999


def test_soar_assign_multi_matches_assign_fused(codebook):
    """The chunked fused path and the step-by-step composition agree."""
    X, cb, _ = codebook
    fused = assign_fused(_t(X), _t(cb), lam=1.0, n_spills=3)
    multi = soar_assign_multi(_t(X), _t(cb), fused[:, 0], lam=1.0, n_spills=3)
    for j in range(4):
        assert _agree(fused[:, j].numpy(), multi[:, j].numpy()) >= 0.999


def test_assign_fused_multi_spill_when_every_centroid_is_taken():
    """c = 3 and three spills: the fourth column has no unused centroid and
    gets index 0, as jnp.argmin over all +inf gives."""
    from repro.kernels.soar_assign import _fused_assign_gemm
    X, cb = _normal(5, 50, 6), _normal(6, 3, 6)
    want = np.asarray(_fused_assign_gemm(jnp.asarray(X), jnp.asarray(cb), lam=1.0,
                                         n_spills=3, chunk=64))
    got = assign_fused(_t(X), _t(cb), lam=1.0, n_spills=3).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, 3] == 0).all()


@pytest.mark.parametrize("lam", [0.0, 1.0, 1.5])
def test_soar_loss_values_match_jax(codebook, lam):
    X, cb, prim = codebook
    cand = np.random.default_rng(7).integers(0, C, len(X)).astype(np.int32)
    want = np.asarray(jax_soar.soar_loss_values(jnp.asarray(X), jnp.asarray(cb),
                                                jnp.asarray(prim), jnp.asarray(cand), lam))
    got = soar_loss_values(_t(X), _t(cb), _t(prim), _t(cand), lam).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ anisotropic
@pytest.mark.parametrize("T,d", [(0.2, 100), (0.2, 32), (0.5, 16), (0.0, 8), (0.99, 4)])
def test_eta_from_threshold_is_exact(T, d):
    assert aniso.eta_from_threshold(T, d) == jax_aniso.eta_from_threshold(T, d)


@pytest.mark.parametrize("T", [0.2, 0.5])
def test_anisotropic_assign_matches_jax(codebook, T):
    X, cb, _ = codebook
    eta = aniso.eta_from_threshold(T, D)
    want = np.asarray(jax_aniso.anisotropic_assign(jnp.asarray(X), jnp.asarray(cb), eta))
    got = aniso.anisotropic_assign(_t(X), _t(cb), eta).numpy()
    assert _agree(got, want) >= 0.999             # tolerance: 99.9% of rows


@pytest.mark.parametrize("max_elems", [aniso.ACCUM_ELEMS, 4096])
def test_anisotropic_update_matches_jax(codebook, max_elems):
    """One update from the same C and assignment against JAX's `_accumulate`
    plus the solve (rtol 1e-4); a small block size runs the many-block
    path. Centroid 0 is left empty and keeps its row."""
    X, cb, _ = codebook
    eta = aniso.eta_from_threshold(T_ANISO, D)
    a = np.asarray(jax_aniso.anisotropic_assign(jnp.asarray(X), jnp.asarray(cb), eta))
    a = np.where(a == 0, 1, a).astype(np.int32)
    st = jax_aniso._accumulate(jnp.asarray(X), jnp.asarray(a), eta, C)
    counts = np.bincount(a, minlength=C)
    new = np.linalg.solve(np.asarray(st.A, np.float64) + 1e-6 * np.eye(D),
                          np.asarray(st.b, np.float64)[..., None])[..., 0]
    want = np.where(counts[:, None] > 0, new, cb)
    A, b, cnt = aniso.normal_equations(_t(X), _t(a), eta, C, max_elems=max_elems)
    np.testing.assert_array_equal(cnt.numpy(), counts)
    np.testing.assert_allclose(A.numpy(), np.asarray(st.A), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(b.numpy(), np.asarray(st.b), rtol=1e-4, atol=1e-4)
    got = aniso._anisotropic_update(_t(X), _t(cb), _t(a), eta).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got[0], cb[0])


def test_anisotropic_kmeans_loss_close_to_jax(codebook):
    """Different random streams: compare the mean anisotropic loss reached
    (within 5%)."""
    X = codebook[0]
    eta = aniso.eta_from_threshold(T_ANISO, D)
    jC, ja = jax_aniso.anisotropic_kmeans(jax.random.PRNGKey(3), jnp.asarray(X), C, eta,
                                          iters=4)
    gC, ga = aniso.anisotropic_kmeans(torch.Generator().manual_seed(3), _t(X), C, eta,
                                      iters=4)
    jl = float(jnp.mean(jax_aniso.anisotropic_loss_values(jnp.asarray(X), jC, ja, eta)))
    gl = float(aniso.anisotropic_loss_values(_t(X), gC, ga, eta).mean())
    assert gl <= 1.05 * jl
    # the returned assignment is the anisotropic argmin under the final C
    assert torch.equal(ga, aniso.anisotropic_assign(_t(X), gC, eta))


def test_anisotropic_loss_values_match_jax(codebook):
    X, cb, prim = codebook
    eta = aniso.eta_from_threshold(T_ANISO, D)
    want = np.asarray(jax_aniso.anisotropic_loss_values(jnp.asarray(X), jnp.asarray(cb),
                                                        jnp.asarray(prim), eta))
    got = aniso.anisotropic_loss_values(_t(X), _t(cb), _t(prim), eta).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ int8
def test_int8_quantize_dequantize_score_match_jax(data):
    X, Q = data
    X = np.concatenate([X[:4000], np.zeros((1, D), np.float32),        # a zero row
                        np.full((1, D), 0.5, np.float32)])             # exact halves
    want = jax_int8.int8_quantize(jnp.asarray(X))
    got = int8.int8_quantize(_t(X))
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))      # bit for bit
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(int8.int8_dequantize(got).numpy(),
                                  np.asarray(jax_int8.int8_dequantize(want)))
    ids = np.random.default_rng(8).integers(0, len(X), 64).astype(np.int32)
    ws = np.asarray(jax_int8.int8_score(jnp.asarray(Q[0]), want, jnp.asarray(ids)))
    np.testing.assert_allclose(int8.int8_score(_t(Q[0]), got, _t(ids)).numpy(), ws,
                               rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def jax_int8_index(data):
    return jax_build(jax.random.PRNGKey(0), data[0], C, spill_mode="soar", lam=1.0,
                     pq_subspaces=M, rerank="int8")


def test_finalize_int8_at_frozen_seam_matches_jax(jax_int8_index, data):
    """JAX's codebook, assignments and PQ: the int8 rows and the memory
    accounting equal JAX's."""
    idx = jax_int8_index
    got = finalize_ivf(torch.Generator().manual_seed(0), _t(data[0]), _t(idx.centroids),
                       _t(idx.assignments), rerank="int8",
                       pq=pq.PQCodebook(_t(np.asarray(idx.pq.centers))))
    assert got.rerank_f32 is None
    np.testing.assert_array_equal(got.rerank_int8.q.numpy(), np.asarray(idx.rerank_int8.q))
    np.testing.assert_array_equal(got.rerank_int8.scale.numpy(),
                                  np.asarray(idx.rerank_int8.scale))
    for rerank in ("int8", "f32"):
        assert got.memory_bytes(rerank) == idx.memory_bytes(rerank)


def test_int8_index_carried_across_searches_like_jax(jax_int8_index, data, gt):
    idx = convert.index_from_numpy(_fields(jax_int8_index), device="cpu")
    assert idx.rerank_f32 is None
    assert idx.memory_bytes() == jax_int8_index.memory_bytes()
    ids, _ = search_jit_batched(pack_ivf(idx), data[1], top_t=TOP_T, final_k=K,
                                rerank_budget=BUDGET, bq=BQ)
    want, _ = jax_search.search_jit_batched(
        jax_search.pack_ivf(jax_int8_index, pair_codes=False), jnp.asarray(data[1]),
        top_t=TOP_T, final_k=K, rerank_budget=BUDGET, bq=BQ)
    assert _agree(ids.numpy(), want) >= 0.995


# ------------------------------------------------------------ k-means modes
def test_lloyd_step_matches_jax(codebook):
    X, cb, _ = codebook
    wC, wa, wd = jax_kmeans.lloyd_step(jnp.asarray(X), jnp.asarray(cb), C)
    gC, ga, gd = kmeans.lloyd_step(_t(X), _t(cb))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    np.testing.assert_array_equal(np.bincount(ga.numpy(), minlength=C),
                                  np.bincount(np.asarray(wa), minlength=C))
    np.testing.assert_allclose(gC.numpy(), np.asarray(wC), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(gd), float(wd), rtol=1e-5)


@pytest.mark.parametrize("k", [1, 3])
def test_assign_euclidean_matches_jax(codebook, k):
    X, cb, _ = codebook
    assert _agree(kmeans.assign_euclidean(_t(X), _t(cb)).numpy(),
                  jax_kmeans.assign_euclidean(jnp.asarray(X), jnp.asarray(cb))) >= 0.999
    got = kmeans.assign_euclidean_topk(_t(X), _t(cb), k).numpy()
    want = np.asarray(jax_kmeans.assign_euclidean_topk(jnp.asarray(X), jnp.asarray(cb), k))
    assert got.shape == want.shape == (len(X), k)
    for j in range(k):
        assert _agree(got[:, j], want[:, j]) >= 0.999


def test_assign_euclidean_topk_ties_go_to_the_lowest_index():
    X = np.zeros((5, 4), np.float32)
    cb = np.ones((6, 4), np.float32)               # every centroid ties
    want = np.asarray(jax_kmeans.assign_euclidean_topk(jnp.asarray(X), jnp.asarray(cb), 3))
    np.testing.assert_array_equal(kmeans.assign_euclidean_topk(_t(X), _t(cb), 3).numpy(), want)


@pytest.mark.parametrize("mode", [dict(init="parallel"), dict(batch_size=2048),
                                  dict(spherical=True),
                                  dict(init="parallel", batch_size=2048, spherical=True)])
def test_kmeans_modes_distortion_close_to_jax(data, mode):
    """Different random streams: the distortion reached within 5% of JAX's
    in the same mode; spherical centroids have unit norm."""
    X = data[0][:8000]
    jr = jax_kmeans.train_kmeans(jax.random.PRNGKey(4), X, C, iters=10,
                                 init_sample=4000, **mode)
    gr = kmeans.train_kmeans(torch.Generator().manual_seed(4), _t(X), C, iters=10,
                             init_sample=4000, **mode)
    assert float(gr.distortion) <= 1.05 * float(jr.distortion)
    if mode.get("spherical"):
        np.testing.assert_allclose(gr.centroids.norm(dim=1).numpy(), 1.0, rtol=1e-5)


def test_kmeans_parallel_init_seeds_are_distinct_and_weighted(data):
    X = _t(data[0][:3000])
    S = kmeans.kmeans_parallel_init(torch.Generator().manual_seed(1), X, 32, l=64)
    assert S.shape == (32, D) and torch.isfinite(S).all()
    assert len({r.numpy().tobytes() for r in S}) == 32


def test_d2_draw_is_an_exact_inverse_cdf():
    """k-means++ draws from an exact integer CDF: a grid of uniforms lands
    on each index in proportion to its weight, a zero weight is never
    drawn, and a row of zeros draws index 0."""
    w = torch.tensor([[1.0, 0.0, 2.0, 0.0, 1.0], [0.0] * 5])
    u = torch.linspace(0, 1, 4001)[:-1]
    idx = torch.stack([kmeans._d2_draw(w, torch.stack([x, x])) for x in u])
    assert torch.bincount(idx[:, 0], minlength=5).tolist() == [1000, 0, 2000, 0, 1000]
    assert bool((idx[:, 1] == 0).all())
    g = torch.Generator().manual_seed(0)
    w = torch.rand((3, 1000), generator=g)
    w[:, ::2] = 0.0
    for _ in range(500):
        i = kmeans._d2_draw(w, torch.rand(3, generator=g))
        assert bool((w[torch.arange(3), i] > 0).all())


def test_unknown_init_raises(data):
    with pytest.raises(ValueError, match="unknown init"):
        kmeans.train_kmeans(torch.Generator(), _t(data[0][:100]), 4, init="random")


# ------------------------------------------------------------ PQ and data
@pytest.fixture(scope="module")
def pq_case(data):
    X = data[0][:3000]
    cb = jax_pq.train_pq(jax.random.PRNGKey(6), jnp.asarray(X), M)
    codes = np.asarray(jax_pq.pq_encode(cb, jnp.asarray(X)))
    return X, data[1][:20], cb, codes


def test_pq_decode_and_scores_match_jax(pq_case):
    X, Q, cb, codes = pq_case
    tcb = pq.PQCodebook(_t(np.asarray(cb.centers)))
    np.testing.assert_allclose(pq.pq_decode(tcb, _t(codes)).numpy(),
                               np.asarray(jax_pq.pq_decode(cb, jnp.asarray(codes))),
                               rtol=1e-6, atol=1e-7)
    lut = np.asarray(jax_pq.pq_lut(cb, jnp.asarray(Q[0])))
    np.testing.assert_allclose(pq.pq_score(_t(lut), _t(codes)).numpy(),
                               np.asarray(jax_pq.pq_score(jnp.asarray(lut), jnp.asarray(codes))),
                               rtol=1e-5, atol=1e-5)
    luts = np.asarray(jax.vmap(lambda q: jax_pq.pq_lut(cb, q))(jnp.asarray(Q)))
    np.testing.assert_allclose(pq.pq_score_batch(_t(luts), _t(codes)).numpy(),
                               np.asarray(jax_pq.pq_score_batch(jnp.asarray(luts),
                                                                jnp.asarray(codes))),
                               rtol=1e-5, atol=1e-5)


def test_train_pq_sequential_quality_close_to_jax(pq_case):
    """Different random streams: the reconstruction error within 5%."""
    X = pq_case[0]

    def err(rec):
        return float(((X - rec) ** 2).sum(-1).mean())

    jcb = jax_pq.train_pq_sequential(jax.random.PRNGKey(3), jnp.asarray(X), M)
    je = err(np.asarray(jax_pq.pq_decode(jcb, jax_pq.pq_encode(jcb, jnp.asarray(X)))))
    gcb = pq.train_pq_sequential(torch.Generator().manual_seed(3), _t(X), M)
    ge = err(pq.pq_decode(gcb, pq.pq_encode(gcb, _t(X))).numpy())
    assert gcb.centers.shape == (M, 16, D // M)
    assert ge <= 1.05 * je


@pytest.mark.parametrize("name", ["make_clustered", "make_uniform", "glove_like"])
def test_data_generators_shapes_and_norms(name):
    if name == "glove_like":
        got = vectors.glove_like(3000, 24, nq=50, seed=1, device="cpu")
        want = jax_vectors.glove_like(3000, 24, nq=50, seed=1)
        assert vectors.glove_like(3000, 24, nq=50, seed=1, device="cpu") is got
        assert got.name == want.name
    else:
        got = getattr(vectors, name)(1, 3000, 24, nq=50, device="cpu")
        want = getattr(jax_vectors, name)(jax.random.PRNGKey(1), 3000, 24, nq=50)
    for a, b in ((got.X, want.X), (got.Q, want.Q)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.norm(dim=1).numpy(), 1.0, rtol=1e-5)
    assert (got.n, got.d) == (want.n, want.d)


# ------------------------------------------------------- monolithic build
@pytest.mark.parametrize("T,n_spills,rerank", [(0.0, 1, "f32"), (T_ANISO, 1, "f32"),
                                               (T_ANISO, 2, "int8")])
def test_build_ivf_recall_close_to_jax(data, gt, T, n_spills, rerank):
    """Free builds with each package's own random stream: the mean
    recall@10 over seeds 0-3 within 0.02 of JAX's (tests/torch_recall.py)."""
    X, Q = data
    kw = dict(spill_mode="soar", lam=1.0, n_spills=n_spills, pq_subspaces=M,
              rerank=rerank, anisotropic_T=T, train_iters=9)

    def port(seed):
        got = build_ivf(torch.Generator().manual_seed(seed), X, C, device="cpu", **kw)
        assert tuple(got.assignments.shape) == (N, n_spills + 1)
        srt = np.sort(got.assignments.numpy(), axis=1)
        assert (srt[:, 1:] != srt[:, :-1]).all()
        assert (got.rerank_int8 is None) == (rerank == "f32")
        return _search_recall(got, Q, gt)

    def ref(seed):
        want = jax_ivf.build_ivf(jax.random.PRNGKey(seed), X, C, **kw)
        assert want.assignments.shape == (N, n_spills + 1)
        return _jax_recall(want, Q, gt)

    assert_recall_means_close(port, ref)


def test_build_ivf_spills_on_the_anisotropic_primary(data):
    """With anisotropy the primary column is the codebook's score-aware
    assignment and the spill is the soar loss on it."""
    X = data[0][:6000]
    timings = {}
    idx = build_ivf(torch.Generator().manual_seed(1), X, 32, anisotropic_T=T_ANISO,
                    train_iters=6, timings=timings, device="cpu")
    eta = aniso.eta_from_threshold(T_ANISO, D)
    prim = idx.assignments[:, 0]
    assert torch.equal(prim, aniso.anisotropic_assign(_t(X), idx.centroids, eta))
    want = np.asarray(jax_soar.soar_assign(jnp.asarray(X), jnp.asarray(idx.centroids.numpy()),
                                           jnp.asarray(prim.numpy()), lam=1.0))
    assert _agree(idx.assignments[:, 1].numpy(), want) >= 0.999
    assert {"kmeans", "spill_assign", "router", "csr", "rerank"} <= set(timings)
    none = build_ivf(torch.Generator().manual_seed(1), X, 32, spill_mode="none",
                     anisotropic_T=T_ANISO, train_iters=6, device="cpu")
    assert torch.equal(none.assignments[:, 0], prim)


def test_sharded_build_variant_recall_close_to_jax(data, gt):
    """The sharded build with anisotropic training, two SOAR spills and
    int8 rerank rows: the mean recall@10 over seeds 0-3 within 0.02 of
    JAX's."""
    X, Q = data
    kw = dict(spill_mode="soar", lam=1.0, n_spills=2, anisotropic_T=T_ANISO,
              rerank="int8", pq_subspaces=M, train_sample=8000, shard_size=6000)

    def port(seed):
        got = build_ivf_sharded(torch.Generator().manual_seed(seed), X, C, device="cpu",
                                **kw)
        assert got.assignments.shape == (N, 3)
        return _search_recall(got, Q, gt)

    assert_recall_means_close(port, lambda seed: _jax_recall(
        jax_build(jax.random.PRNGKey(seed), X, C, **kw), Q, gt))


def test_sharded_multi_spill_at_frozen_seam_matches_jax(jax_int8_index, data):
    X = data[0]
    cb = np.asarray(jax_int8_index.centroids)
    want = jax_build(None, X, C, n_spills=2, codebook=cb, rerank="int8")
    got = build_ivf_sharded(None, X, C, n_spills=2, codebook=cb, rerank="int8",
                            device="cpu")
    ga = got.assignments.numpy()
    for j in range(3):
        assert _agree(ga[:, j], want.assignments[:, j]) >= 0.999
    np.testing.assert_array_equal(got.rerank_int8.q.numpy(), np.asarray(want.rerank_int8.q))


@pytest.mark.parametrize("init,batch_size", [("parallel", None), ("pp", 4096)])
def test_sharded_build_flagged_modes_recall_close_to_jax(data, gt, init, batch_size):
    X, Q = data
    kw = dict(pq_subspaces=M, train_sample=8000, init=init, batch_size=batch_size,
              train_iters=10)
    assert_recall_means_close(
        lambda seed: _search_recall(build_ivf_sharded(
            torch.Generator().manual_seed(seed), X, C, device="cpu", **kw), Q, gt),
        lambda seed: _jax_recall(jax_build(jax.random.PRNGKey(seed), X, C, **kw), Q, gt))


# ---------------------------------------------------------------- repairs
def test_mutable_index_with_tombstones_searches_like_jax():
    """A JAX MutableIVF with 600 of 3,000 points hard-removed leaves -1s
    inside its partitions' slots; carried across, the port's search ids
    equal JAX's on >= 0.995 of slots (0.503 when the port read slots only
    up to the live count)."""
    ds = vectors.make_manifold(3, 3000, 16, nq=100, device="cpu")
    X, Q = ds.X.numpy(), ds.Q.numpy()
    mut = MutableIVF.build(jax.random.PRNGKey(0), X, 20, pq_subspaces=8,
                           compact_threshold=1.0)
    mut.remove(np.random.default_rng(0).choice(3000, 600, replace=False), hard=True)
    jp = mut.pack(pair_codes=False)
    ids = np.asarray(jp.part_ids)
    live = (ids >= 0).sum(1)
    extent = np.array([np.nonzero(r >= 0)[0].max() + 1 if (r >= 0).any() else 0
                       for r in ids])
    assert (extent > live).any()                 # dead slots inside the extent
    packed = convert.packed_from_numpy(
        {"centroids": np.asarray(jp.centroids), "part_ids": ids,
         "part_codes": np.asarray(jp.part_codes), "sizes": np.asarray(jp.sizes),
         "pq.centers": np.asarray(jp.pq.centers), "rerank": np.asarray(jp.rerank)},
        device="cpu")
    np.testing.assert_array_equal(packed.extent.numpy(), extent)
    np.testing.assert_array_equal(packed.sizes.numpy(), live)
    kw = dict(top_t=6, final_k=K, rerank_budget=64, bq=64)
    want, _ = jax_search.search_jit_batched(jp, jnp.asarray(Q), **kw)
    got, _ = search_jit_batched(packed, Q, **kw)
    assert _agree(got.numpy(), want) >= 0.995
    g = got.numpy()
    assert mut.alive[g[g >= 0]].all()            # no removed point returned


def test_flat_route_ties_follow_lax_top_k():
    """Duplicate centroids and integer data make exact ties: the flat
    route's scores and partitions equal `jax.lax.top_k`'s, lowest index
    first."""
    rng = np.random.default_rng(9)
    cents = rng.integers(-3, 4, (12, 8)).astype(np.float32)
    cents = np.concatenate([cents, cents[::-1], cents[:5]])       # c = 29
    Q = rng.integers(-3, 4, (40, 8)).astype(np.float32)
    for t in (1, 7, 29):
        ws, wp = JaxFlatRouter(jnp.asarray(cents)).route(jnp.asarray(Q), t)
        gs, gp = FlatRouter(_t(cents)).route(_t(Q), t)
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
