"""The port's probe routers (repro_torch.core.router) and the plain version
of its tree_route kernel against the JAX package, on the same numpy
inputs, on the CPU: the route kernel against `tree_route_pallas` in
interpret mode, a tree router carried across from JAX against JAX's own
route and search, the children grouping, the tree's degradation to flat
routing, the escalation policy, and tree-routed builds. The index is the
one tests/test_torch_slice.py uses (n=20k, d=32, c=64, m=8).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _hypothesis_compat import given, settings, st  # noqa: E402

from repro.core import search as jax_search  # noqa: E402
from repro.core.build import build_ivf_sharded as jax_build  # noqa: E402
from repro.core.kmr import true_neighbors as jax_true_neighbors  # noqa: E402
from repro.core.router import train_tree_router as jax_train_tree_router  # noqa: E402
from repro.kernels.tree_route import tree_route_pallas  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import (build_ivf_sharded, pack_ivf, recall_at_k,  # noqa: E402
                              search_jit_batched)
from repro_torch.core.router import (FlatRouter, TreeRouter, _group_children,  # noqa: E402
                                     as_router, clamp_top_t, train_tree_router)
from repro_torch.data.vectors import make_manifold  # noqa: E402
from repro_torch.kernels.tree_route import tree_route  # noqa: E402

N, D, C, M, NQ = 20_000, 32, 64, 8, 200
TOP_T, K, BUDGET, BQ = 8, 10, 64, 64


def _t(a, device="cpu"):
    return torch.from_numpy(np.array(a)).to(device)


def index_fields(idx):
    """A JAX IVFIndex, router included, as convert.index_from_numpy's fields."""
    f = {"centroids": np.asarray(idx.centroids), "starts": idx.starts,
         "point_ids": idx.point_ids, "codes": idx.codes,
         "pq.centers": None if idx.pq is None else np.asarray(idx.pq.centers),
         "rerank_f32": idx.rerank_f32, "assignments": idx.assignments,
         "n_points": idx.n_points, "spill_mode": idx.spill_mode, "lam": idx.lam}
    if idx.router is not None:
        f.update(router_fields(idx.router))
    return f


def router_fields(rt):
    """A JAX TreeRouter under the names of the JAX snapshot codec."""
    return {"router": {"type": "tree", "t_route": rt.t_route,
                       "n_partitions": rt.n_partitions},
            "router.super_centroids": np.asarray(rt.super_centroids),
            "router.children": np.asarray(rt.children),
            "router.child_centroids": np.asarray(rt.child_centroids)}


def carried(rt) -> TreeRouter:
    """A JAX TreeRouter's tables as the port's TreeRouter on the CPU."""
    return TreeRouter(_t(np.asarray(rt.super_centroids)), _t(np.asarray(rt.children)),
                      _t(np.asarray(rt.child_centroids)), rt.t_route, rt.n_partitions)


@pytest.fixture(scope="module")
def data():
    ds = make_manifold(0, N, D, nq=NQ, device="cpu")
    return ds.X.numpy(), ds.Q.numpy()


@pytest.fixture(scope="module")
def jax_tree_index(data):
    """The JAX build of test_torch_slice's index, with a tree router trained
    by the JAX package (S = 8 supers, t_route = 4)."""
    return jax_build(jax.random.PRNGKey(0), data[0], C, spill_mode="soar", lam=1.0,
                     pq_subspaces=M, router="tree", router_kw={"t_route": 4})


@pytest.fixture(scope="module")
def jax_tree(jax_tree_index):
    return jax_train_tree_router(jax.random.PRNGKey(2), jax_tree_index.centroids)


# ------------------------------------------------------- kernel 6: tree route
def _tree_tables(seed, S, cmax, d, frac_pad=0.25):
    """Random router tables with ragged children (-1 pad, as training makes)."""
    rng = np.random.default_rng(seed)
    SC = rng.standard_normal((S, d)).astype(np.float32)
    CC = rng.standard_normal((S, cmax, d)).astype(np.float32)
    pad = rng.uniform(size=(S, cmax)) < frac_pad
    pad[:, 0] = False                       # every super keeps >= 1 child
    CH = np.where(pad, -1, np.arange(S * cmax).reshape(S, cmax)).astype(np.int32)
    CC[pad] = 0.0
    return SC, CC, CH


@pytest.mark.parametrize("nq,S,cmax,d,tr", [
    (1, 4, 3, 8, 1), (7, 16, 9, 32, 3), (40, 8, 16, 16, 8), (130, 32, 5, 24, 4),
])
def test_tree_route_matches_pallas(nq, S, cmax, d, tr):
    Q = np.random.default_rng(40).standard_normal((nq, d)).astype(np.float32)
    SC, CC, CH = _tree_tables(41, S, cmax, d)
    ws, wi = tree_route_pallas(jnp.asarray(Q), jnp.asarray(SC), jnp.asarray(CC),
                               jnp.asarray(CH), t_route=tr, bq=64, interpret=True)
    gs, gi = tree_route(_t(Q), _t(SC), _t(CC), _t(CH), tr)
    ws, wi, gs, gi = np.asarray(ws), np.asarray(wi), gs.numpy(), gi.numpy()
    assert gs.shape == gi.shape == (nq, tr * cmax) and gi.dtype == np.int32
    # random normals: no super-score ties, so the rounds pick the same supers
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(np.isfinite(gs), np.isfinite(ws))
    np.testing.assert_array_equal(np.isfinite(gs), gi >= 0)
    fin = np.isfinite(ws)
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=1e-4, atol=1e-4)


def test_tree_route_ties_go_to_the_lowest_super():
    """Equal super scores: the lower index is routed first, as lax.top_k."""
    SC = np.ones((5, 4), np.float32)
    CC = np.random.default_rng(42).standard_normal((5, 2, 4)).astype(np.float32)
    CH = np.arange(10, dtype=np.int32).reshape(5, 2)
    _, ids = tree_route(_t(np.ones((3, 4), np.float32)), _t(SC), _t(CC), _t(CH), 3)
    np.testing.assert_array_equal(ids.numpy(), np.tile(np.arange(6), (3, 1)))


# ---------------------------------------------------- routers carried from JAX
@pytest.mark.parametrize("top_t", [TOP_T, C])
def test_route_matches_jax(jax_tree, data, top_t):
    """top_t = c reaches past the routed children: starved slots are
    partition 0 at -inf in both packages."""
    Q = data[1]
    wv, wp = jax_tree.route(jnp.asarray(Q), top_t)
    gv, gp = carried(jax_tree).route(_t(Q), top_t)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(np.isfinite(gv.numpy()), np.isfinite(np.asarray(wv)))
    fin = np.isfinite(np.asarray(wv))
    np.testing.assert_allclose(gv.numpy()[fin], np.asarray(wv)[fin], rtol=1e-5, atol=1e-5)


def test_escalated_route_matches_jax(jax_tree, data):
    Q = data[1]
    jr, jt = jax_tree.escalated(TOP_T)
    gr, gt = carried(jax_tree).escalated(TOP_T)
    assert (gr.t_route, gt) == (jr.t_route, jt)
    np.testing.assert_array_equal(gr.route(_t(Q), gt)[1].numpy(),
                                  np.asarray(jr.route(jnp.asarray(Q), jt)[1]))


def test_group_children_matches_jax(jax_tree, jax_tree_index):
    children, child_centroids = _group_children(
        _t(np.asarray(jax_tree_index.centroids)), _t(np.asarray(jax_tree.super_centroids)))
    np.testing.assert_array_equal(children.numpy(), np.asarray(jax_tree.children))
    np.testing.assert_array_equal(child_centroids.numpy(),
                                  np.asarray(jax_tree.child_centroids))


def test_search_with_carried_router_matches_jax(jax_tree_index, data):
    """The router rides across in the index's fields and is packed with it;
    both packages search through it."""
    Q = data[1]
    packed = pack_ivf(convert.index_from_numpy(index_fields(jax_tree_index),
                                               device="cpu"))
    assert isinstance(packed.router, TreeRouter)
    ids, scores = search_jit_batched(packed, Q, top_t=TOP_T, final_k=K,
                                     rerank_budget=BUDGET, bq=BQ)
    jp = jax_search.pack_ivf(jax_tree_index, pair_codes=False)
    wids, wscores = jax_search.search_jit_batched(jp, jnp.asarray(Q), top_t=TOP_T,
                                                  final_k=K, rerank_budget=BUDGET, bq=BQ)
    same = ids.numpy() == np.asarray(wids)
    assert same.mean() >= 0.995
    np.testing.assert_allclose(scores.numpy()[same], np.asarray(wscores)[same], rtol=1e-5)


# --------------------------------------------------------------- the policy
@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), c=st.integers(6, 48),
       d=st.integers(2, 12), t=st.integers(1, 16))
def test_tree_at_full_t_route_degrades_to_flat(seed, c, d, t):
    """At t_route = n_super every child is scored, so the tree probe set is
    the flat one. Integer-valued data keeps both score paths exact, and
    rows with a score tie at the top-t boundary are skipped (the set is
    only well-defined with a strict gap)."""
    rng = np.random.default_rng(seed)
    C_ = rng.integers(-8, 8, (c, d)).astype(np.float32)
    Q = rng.integers(-8, 8, (5, d)).astype(np.float32)
    t = clamp_top_t(t, c) or 1
    rt = train_tree_router(torch.Generator().manual_seed(seed % 997), _t(C_),
                           n_super=max(2, int(np.sqrt(c))), iters=3)
    rt = rt.with_t_route(rt.n_super)
    sc = Q @ C_.T
    srt = -np.sort(-sc, axis=1)
    gap = srt[:, t - 1] > srt[:, t] if t < c else np.ones(5, bool)
    _, fp = FlatRouter(_t(C_)).route(_t(Q), t)
    _, tp = rt.route(_t(Q), t)
    for g, a, b in zip(gap, fp.numpy(), tp.numpy()):
        if g:
            assert set(a.tolist()) == set(b.tolist())


def test_escalation_through_the_router(jax_tree_index):
    """Escalation doubles the cut (top_t) and, for a tree, the reachable
    set (t_route); a tree is exhausted only when both are at their maximum."""
    cents = _t(np.asarray(jax_tree_index.centroids))
    tree = train_tree_router(torch.Generator().manual_seed(2), cents, n_super=8,
                             t_route=3)
    r2, t2 = tree.escalated(4)
    assert t2 == 8
    assert r2.t_route == min(2 * tree.eff_t_route, tree.n_super) == 6
    assert tree.can_escalate(tree.n_partitions) is True   # t_route headroom
    full = tree.with_t_route(tree.n_super)
    assert full.can_escalate(full.n_partitions) is False
    assert full.escalated(C)[0].t_route == tree.n_super
    flat = FlatRouter(cents)
    assert flat.escalated(40) == (flat, C)
    assert flat.can_escalate(C - 1) and not flat.can_escalate(C)
    assert tree.probe_flops(TOP_T) < flat.probe_flops(TOP_T)


def test_as_router_specs(jax_tree_index):
    cents = _t(np.asarray(jax_tree_index.centroids))
    assert as_router(None, cents) is None
    assert isinstance(as_router("flat", cents), FlatRouter)
    rt = as_router("tree", cents, n_super=5, t_route=2)
    assert (rt.n_super, rt.t_route, rt.n_partitions) == (5, 2, C)
    assert as_router(rt, cents) is rt
    with pytest.raises(ValueError, match="unknown router spec"):
        as_router("ivf", cents)


def test_train_tree_router_defaults_and_tables(jax_tree_index):
    cents = _t(np.asarray(jax_tree_index.centroids))
    rt = train_tree_router(None, cents)
    assert (rt.n_super, rt.t_route) == (8, 1)             # round(√64), ceil(8/8)
    ch = rt.children.numpy()
    assert sorted(ch[ch >= 0].tolist()) == list(range(C))  # every partition once
    live = ch >= 0
    np.testing.assert_array_equal(rt.child_centroids.numpy()[live],
                                  cents.numpy()[ch[live]])
    assert not rt.child_centroids.numpy()[~live].any()
    deg = train_tree_router(None, cents[:6], n_super=10)   # S >= c: one child each
    np.testing.assert_array_equal(deg.children.numpy()[:, 0], np.arange(6))


# ------------------------------------------------------------------- builds
def test_tree_build_leaves_the_index_unchanged(data):
    X = data[0][:5000]
    kw = dict(spill_mode="soar", lam=1.0, pq_subspaces=M, device="cpu")
    flat = build_ivf_sharded(torch.Generator().manual_seed(0), X, 32, **kw)
    times = {}
    tree = build_ivf_sharded(torch.Generator().manual_seed(0), X, 32, router="tree",
                             router_kw={"t_route": 2}, timings=times, **kw)
    assert flat.router is None and isinstance(tree.router, TreeRouter)
    assert (tree.router.t_route, tree.router.n_partitions) == (2, 32)
    assert "router" in times
    for name in ("centroids", "starts", "point_ids", "codes", "rerank_f32",
                 "assignments"):
        assert torch.equal(getattr(flat, name), getattr(tree, name)), name
    assert torch.equal(flat.pq.centers, tree.pq.centers)
    frozen = build_ivf_sharded(None, X, 32, codebook=tree.centroids, pq=tree.pq,
                               router=tree.router, **kw)
    assert frozen.router.children is tree.router.children      # kept, not retrained


def test_free_tree_build_recall_close_to_jax(jax_tree_index, data):
    X, Q = data
    gt = np.asarray(jax_true_neighbors(X, Q, k=K))
    jp = jax_search.pack_ivf(jax_tree_index, pair_codes=False)
    wids, _ = jax_search.search_jit_batched(jp, jnp.asarray(Q), top_t=TOP_T, final_k=K,
                                            rerank_budget=BUDGET, bq=BQ)
    idx = build_ivf_sharded(torch.Generator().manual_seed(0), X, C, spill_mode="soar",
                            lam=1.0, pq_subspaces=M, router="tree",
                            router_kw={"t_route": 4}, device="cpu")
    ids, _ = search_jit_batched(pack_ivf(idx), Q, top_t=TOP_T, final_k=K,
                                rerank_budget=BUDGET, bq=BQ)
    got = recall_at_k(ids, _t(gt), K)
    want = recall_at_k(_t(np.asarray(wids)), _t(gt), K)
    assert abs(got - want) <= 0.02, (got, want)
