"""The port's paper metrics (repro_torch.core.kmr, repro_torch.core.analysis)
against the JAX package on the same inputs: KMR curves, points-to-recall,
rank statistics, the residual pair statistics and their correlations, and
Figure 1's mean ⟨q, r⟩ by rank.

Three JAX indexes (no spill, naive spill, SOAR) share one codebook (the
same key trains the same sample) and are carried across with
`convert.index_from_numpy`; data and queries are made by numpy from a
seed. Runs on the CPU at n = 6,000, d = 24, c = 32, 60 queries, k = 20;
tests/test_torch_cuda.py repeats the curve on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import analysis as jax_analysis  # noqa: E402
from repro.core import kmr as jax_kmr  # noqa: E402
from repro.core.build import build_ivf_sharded as jax_build  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import (KMRCurve, kmr_curve, points_to_recall,  # noqa: E402
                              rank_statistics)
from repro_torch.core import analysis  # noqa: E402
from repro_torch.core.kmr import _kmr_core  # noqa: E402

N, D, C, NQ, K = 6000, 24, 32, 60, 20
MODES = ("none", "naive", "soar")


def manifold(seed, n, d, nq, p=6, hidden=64):
    """Unit vectors on a p-dimensional manifold (a random two-layer map),
    made by numpy: (X (n, d), Q (nq, d)) f32."""
    rng = np.random.default_rng(seed)
    W1 = rng.standard_normal((p, hidden))
    W2 = rng.standard_normal((hidden, d)) / np.sqrt(hidden)
    Y = np.tanh(2.0 * rng.standard_normal((n + nq, p)) @ W1 / np.sqrt(p)) @ W2
    Y = (Y / np.linalg.norm(Y, axis=1, keepdims=True)).astype(np.float32)
    return Y[:n], Y[n:]


def _fields(idx):
    """A JAX IVFIndex as the numpy fields convert.index_from_numpy takes."""
    return {"centroids": np.asarray(idx.centroids), "starts": idx.starts,
            "point_ids": idx.point_ids, "codes": idx.codes, "pq.centers": None,
            "rerank_f32": idx.rerank_f32, "assignments": idx.assignments,
            "n_points": idx.n_points, "spill_mode": idx.spill_mode,
            "lam": idx.lam}


@pytest.fixture(scope="module")
def data():
    X, Q = manifold(3, N, D, NQ)
    return X, Q, np.asarray(jax_kmr.true_neighbors(X, Q, k=K))


@pytest.fixture(scope="module")
def indexes(data):
    """mode → (JAX IVFIndex, the port's IVFIndex carried across)."""
    out = {}
    for mode in MODES:
        j = jax_build(jax.random.PRNGKey(1), data[0], C, spill_mode=mode,
                      train_iters=5)
        out[mode] = (j, convert.index_from_numpy(_fields(j), device="cpu"))
    assert all(np.array_equal(out[m][0].centroids, out["none"][0].centroids)
               for m in MODES)
    return out


@pytest.fixture(scope="module")
def curves(data, indexes):
    """mode → (JAX curve, the port's curve)."""
    _, Q, tid = data
    return {m: (jax_kmr.kmr_curve(j, Q, tid, k=K), kmr_curve(t, Q, tid, k=K))
            for m, (j, t) in indexes.items()}


@pytest.mark.parametrize("mode", MODES)
def test_kmr_curve_matches_jax(curves, indexes, mode):
    want, got = curves[mode]
    assert isinstance(got, KMRCurve) and got.name == want.name == mode
    np.testing.assert_array_equal(got.points_at_t, want.points_at_t)
    np.testing.assert_allclose(got.recall_at_t, want.recall_at_t, rtol=0, atol=1e-6)
    # the paper's properties: non-decreasing, complete at t = c
    assert np.all(np.diff(got.recall_at_t) >= 0)
    assert got.recall_at_t[-1] == 1.0
    # the mean is the sum times f32(1 / nq), as XLA computes it: one rounding
    assert abs(got.points_at_t[-1] - indexes[mode][1].n_assignments) <= 1e-3


def test_spilling_dominates_at_fixed_t(curves):
    """With one codebook, a spilled neighbour's best rank is at most its
    primary's, so recall at every t can only rise."""
    none = curves["none"][1].recall_at_t
    for mode in ("naive", "soar"):
        assert np.all(curves[mode][1].recall_at_t >= none)


@pytest.mark.parametrize("mode", MODES)
def test_points_to_recall_matches_jax(curves, mode):
    want, got = curves[mode]
    for target in (0.0, 0.5, 0.8, 0.9, 0.95, 0.99, 1.0, 1.1):
        w, g = jax_kmr.points_to_recall(want, target), points_to_recall(got, target)
        if np.isinf(w):
            assert np.isinf(g), target
        else:
            assert abs(g - w) <= 1e-6 * max(1.0, abs(w)), (target, g, w)


@pytest.mark.parametrize("mode", ("naive", "soar"))
def test_rank_statistics_match_jax(data, indexes, mode):
    _, Q, tid = data
    j, t = indexes[mode]
    wp, ws = jax_kmr.rank_statistics(j, Q, tid)
    gp, gs = rank_statistics(t, Q, tid)
    assert gp.shape == gs.shape == (NQ, K)
    assert float((gp.numpy() == wp).mean()) >= 0.999
    assert float((gs.numpy() == ws).mean()) >= 0.999


def test_kmr_core_counts_every_neighbour_once(data, indexes):
    """The scatter of best ranks puts each of a query's k neighbours in one
    bin: the last column counts k, and the counts equal a one-hot sum."""
    _, Q, tid = data
    idx = indexes["soar"][1]
    Qt, tt = torch.tensor(Q), torch.tensor(tid)
    recall, pts = _kmr_core(idx.centroids, idx.partition_sizes().float(),
                            idx.assignments, Qt, tt, K)
    assert torch.equal(recall[:, -1], torch.ones(NQ))
    scores = Qt @ idx.centroids.T
    rank = torch.argsort(torch.argsort(-scores, dim=1, stable=True), dim=1)
    best = rank.gather(1, idx.assignments[tt.long()].long().reshape(NQ, -1)) \
        .reshape(NQ, K, -1).amin(2)
    onehot = torch.nn.functional.one_hot(best, C).sum(1).cumsum(1)
    assert torch.equal(recall, onehot.float() * (1.0 / K))
    assert torch.equal(pts[:, -1], torch.full((NQ,), float(idx.n_assignments)))


@pytest.fixture(scope="module")
def pair_stats(data, indexes):
    """mode → (JAX PairStats, the port's PairStats) for the spilled modes."""
    X, Q, tid = data
    out = {}
    for mode in ("naive", "soar"):
        j, t = indexes[mode]
        out[mode] = (jax_analysis.pair_stats(X, j.centroids, j.assignments, Q, tid),
                     analysis.pair_stats(torch.tensor(X), t.centroids,
                                         t.assignments, torch.tensor(Q),
                                         torch.tensor(tid)))
    return out


@pytest.mark.parametrize("mode", ("naive", "soar"))
def test_pair_stats_match_jax(pair_stats, mode):
    want, got = pair_stats[mode]
    for name in want._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(want, name),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("mode", ("naive", "soar"))
def test_correlations_match_jax(pair_stats, mode):
    want, got = pair_stats[mode]
    for fn in ("score_error_correlation", "angle_correlation"):
        w = getattr(jax_analysis, fn)(want)
        g = getattr(analysis, fn)(got)
        assert abs(g - w) <= 1e-5, (fn, g, w)
    assert abs(analysis.pearson(got.qr, got.qr) - 1.0) <= 1e-5


def test_soar_decorrelates_residuals(pair_stats):
    """The paper's Figure 9: SOAR's spilled residual is less correlated with
    the primary's than naive spilling's."""
    assert (analysis.score_error_correlation(pair_stats["soar"][1])
            < analysis.score_error_correlation(pair_stats["naive"][1]))


def test_mean_qr_by_rank_matches_jax(data, indexes):
    X, Q, tid = data
    j, t = indexes["soar"]
    wc, wm = jax_analysis.mean_qr_by_rank(X, j.centroids, j.assignments, Q, tid, n_bins=8)
    gc, gm = analysis.mean_qr_by_rank(X, t.centroids, t.assignments, Q, tid, n_bins=8)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_allclose(gm, wm, rtol=0, atol=1e-5)


def test_analysis_runs_on_the_card_unless_asked(data, indexes):
    """With numpy inputs the work goes to CUDA by default: without a card
    that raises instead of running on the CPU; device="cpu" runs here."""
    X, Q, tid = data
    j = indexes["soar"][0]
    C_np = np.asarray(j.centroids)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            analysis.pair_stats(X, C_np, j.assignments, Q, tid)
    st = analysis.pair_stats(X, C_np, j.assignments, Q, tid, device="cpu")
    assert st.qr.device.type == "cpu" and st.qr.shape == (NQ * K,)
