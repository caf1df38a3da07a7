"""The port's filtered search (a per-window bitmap plus the router-escalated
second pass) against the JAX package on the same index, routers and
bitmaps, on the CPU. The index is the one tests/test_torch_slice.py uses
(n=20k, d=32, c=64, m=8); the tree router is trained by the JAX package
and carried across.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import search as jax_search  # noqa: E402
from repro.core.build import build_ivf_sharded as jax_build  # noqa: E402
from repro.core.router import FlatRouter as JaxFlatRouter  # noqa: E402
from repro.core.router import train_tree_router as jax_train_tree_router  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import FlatRouter, TreeRouter, pack_ivf, search  # noqa: E402
from repro_torch.core import search_jit, search_jit_batched  # noqa: E402
from repro_torch.data.vectors import make_manifold  # noqa: E402

N, D, C, M, NQ = 20_000, 32, 64, 8, 200
TOP_T, K, BUDGET, BQ = 8, 10, 64, 64


def _t(a, device="cpu"):
    return torch.from_numpy(np.array(a)).to(device)


def _fields(idx):
    return {"centroids": np.asarray(idx.centroids), "starts": idx.starts,
            "point_ids": idx.point_ids, "codes": idx.codes,
            "pq.centers": None if idx.pq is None else np.asarray(idx.pq.centers),
            "rerank_f32": idx.rerank_f32, "assignments": idx.assignments,
            "n_points": idx.n_points, "spill_mode": idx.spill_mode, "lam": idx.lam}


def _bitmap(selectivity, seed=7):
    rng = np.random.default_rng(seed)
    bits = np.zeros(N, np.uint8)
    bits[rng.choice(N, int(round(selectivity * N)), replace=False)] = 1
    return bits


@pytest.fixture(scope="module")
def data():
    ds = make_manifold(0, N, D, nq=NQ, device="cpu")
    return ds.X.numpy(), ds.Q.numpy()


@pytest.fixture(scope="module")
def jax_index(data):
    return jax_build(jax.random.PRNGKey(0), data[0], C, spill_mode="soar",
                     lam=1.0, pq_subspaces=M)


@pytest.fixture(scope="module")
def routers(jax_index):
    """(JAX router, the port's router) pairs by name; the tree is JAX's
    default (S = 8 supers, t_route = 1)."""
    jt = jax_train_tree_router(jax.random.PRNGKey(2), jax_index.centroids)
    tree = TreeRouter(_t(np.asarray(jt.super_centroids)), _t(np.asarray(jt.children)),
                      _t(np.asarray(jt.child_centroids)), jt.t_route, jt.n_partitions)
    cents = np.asarray(jax_index.centroids)
    return {"flat": (JaxFlatRouter(jnp.asarray(cents)), FlatRouter(_t(cents))),
            "tree": (jt.device(), tree)}


@pytest.fixture(scope="module")
def packs(jax_index):
    return (jax_search.pack_ivf(jax_index, pair_codes=False),
            pack_ivf(convert.index_from_numpy(_fields(jax_index), device="cpu")))


@pytest.mark.parametrize("router", ["flat", "tree"])
@pytest.mark.parametrize("escalate", [True, False])
@pytest.mark.parametrize("selectivity", [0.05, 0.01])
def test_filtered_search_matches_jax(packs, routers, data, router, escalate,
                                     selectivity):
    """At 5% no window is thin; at 1% the escalated pass replaces rows."""
    bits = _bitmap(selectivity)
    jr, tr = routers[router]
    wids, wscores = jax_search.search_jit_batched(
        packs[0], jnp.asarray(data[1]), top_t=TOP_T, final_k=K, rerank_budget=BUDGET,
        bq=BQ, filter=jnp.asarray(bits), escalate=escalate, router=jr)
    ids, scores = search_jit_batched(packs[1], data[1], top_t=TOP_T, final_k=K,
                                     rerank_budget=BUDGET, bq=BQ, filter=bits,
                                     escalate=escalate, router=tr)
    same = ids.numpy() == np.asarray(wids)
    assert same.mean() >= 0.995
    np.testing.assert_allclose(scores.numpy()[same], np.asarray(wscores)[same], rtol=1e-5)


@pytest.mark.parametrize("router", ["flat", "tree"])
def test_surviving_counts_match_jax(packs, routers, data, router):
    """The escalation signal: unique surviving candidates, capped at the
    rerank budget, per query of one tile."""
    bits = _bitmap(0.01)
    jr, tr = routers[router]
    Q = data[1][:BQ]
    _, _, wsurv = jax_search._search_pass(packs[0], jnp.asarray(Q), jr, TOP_T, K, BUDGET,
                                          2, jnp.asarray(bits))
    _, _, surv = search._search_pass(packs[1], _t(Q), tr, TOP_T, K, BUDGET, 2,
                                     _t(bits))
    assert (surv.numpy() == np.asarray(wsurv)).mean() >= 0.99
    assert (surv.numpy() < BUDGET).any()           # some windows are thin here


@pytest.mark.parametrize("selectivity", [0.01, 0.05])
def test_filtered_results_pass_the_filter(packs, routers, data, selectivity):
    bits = _bitmap(selectivity, seed=11)
    kw = dict(top_t=TOP_T, final_k=K, rerank_budget=BUDGET, bq=BQ, filter=bits,
              router=routers["tree"][1])
    esc, _ = search_jit_batched(packs[1], data[1], escalate=True, **kw)
    plain, _ = search_jit_batched(packs[1], data[1], escalate=False, **kw)
    for ids in (esc.numpy(), plain.numpy()):
        assert bits[ids[ids >= 0]].all()
    # an escalated row never holds fewer results than the first pass gave it
    assert ((esc >= 0).sum(1) >= (plain >= 0).sum(1)).all()


def test_escalation_replaces_thin_rows(packs, routers, data):
    """At 1% the tree's first pass (one super of eight) leaves windows
    thinner than the budget; escalation reaches two supers for them."""
    bits = _bitmap(0.01, seed=11)
    kw = dict(top_t=TOP_T, final_k=K, rerank_budget=BUDGET, bq=BQ, filter=bits,
              router=routers["tree"][1])
    esc, _ = search_jit_batched(packs[1], data[1], escalate=True, **kw)
    plain, _ = search_jit_batched(packs[1], data[1], escalate=False, **kw)
    assert bool((esc != plain).any(dim=1).any())


def test_all_pass_filter_is_the_unfiltered_search(packs, data):
    kw = dict(top_t=TOP_T, final_k=K, rerank_budget=BUDGET, bq=BQ)
    ids, scores = search_jit_batched(packs[1], data[1], **kw)
    fids, fscores = search_jit_batched(packs[1], data[1], filter=np.ones(N, bool),
                                       escalate=False, **kw)
    assert torch.equal(ids, fids) and torch.equal(scores, fscores)


def test_filtered_exact_window_matches_jax(data):
    """No PQ stage: survivors are counted among the final_k slots."""
    X, Q = data
    idx = jax_build(jax.random.PRNGKey(1), X, C, spill_mode="naive")
    bits = _bitmap(0.01, seed=3)
    want, _ = jax_search.search_jit_batched(jax_search.pack_ivf(idx), jnp.asarray(Q),
                                            top_t=TOP_T, final_k=K, bq=BQ,
                                            filter=jnp.asarray(bits))
    got, _ = search_jit_batched(pack_ivf(convert.index_from_numpy(_fields(idx),
                                                                  device="cpu")),
                                Q, top_t=TOP_T, final_k=K, bq=BQ, filter=bits)
    assert (got.numpy() == np.asarray(want)).mean() >= 0.995
    assert bits[got.numpy()[got.numpy() >= 0]].all()


@pytest.mark.parametrize("selectivity", [0.01, 0.002])
def test_budget_mode_matches_the_jax_host_engine(jax_index, packs, data, selectivity):
    """`escalate="budget"` on the device, tile by tile, against JAX's host
    engine `search_numpy(filter_mask=, escalate=True)`, which walks thin
    queries up the same escalation steps to min(budget, population)."""
    bits = _bitmap(selectivity)
    want, _ = jax_search.search_numpy(jax_index, data[1], top_t=TOP_T, final_k=K,
                                      rerank_budget=BUDGET, filter_mask=bits, escalate=True)
    got, _ = search_jit_batched(packs[1], data[1], top_t=TOP_T, final_k=K,
                                rerank_budget=BUDGET, bq=BQ, tile_rows=BQ, filter=bits,
                                escalate="budget")
    assert (got.numpy() == np.asarray(want)).mean() >= 0.995
    assert bits[got.numpy()[got.numpy() >= 0]].all()


@pytest.mark.parametrize("length", [N - 1, N + 5])
def test_filter_of_the_wrong_length_raises(packs, data, length):
    with pytest.raises(ValueError, match="bitmap over the index's points"):
        search_jit(packs[1], data[1][:4], top_t=TOP_T, final_k=K,
                   filter=np.ones(length, np.uint8))
