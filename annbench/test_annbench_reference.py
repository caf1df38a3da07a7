"""The plain references against brute-force NumPy, and the control's TF32
rounding."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from annbench import compare
from annbench.reference import build as rb
from annbench.reference import router as rr
from annbench.reference import search as ref
from annbench.reference.precision import tf32_round


def unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def index(rng, n=400, d=8, c=12, m=4, tree=False):
    """A small index laid out as the program lays one out: each row in its
    nearest partition and its SOAR spill, PQ codes of its residuals."""
    X = unit(rng, n, d)
    C = X[rng.choice(n, c, replace=False)] * 0.9
    centers = rng.standard_normal((m, 16, d // m)).astype(np.float32) * 0.1
    Xt, Ct = torch.from_numpy(X), torch.from_numpy(C)
    prim = rb.assign_choice(Xt, Ct)
    spill = rb.spill_choice(Xt, Ct, prim, 1.0)
    slots = [[] for _ in range(c)]
    for i in range(n):
        slots[int(prim[i])].append(i)
        slots[int(spill[i])].append(i)
    cap = max(len(s) for s in slots) + 2
    pid = -np.ones((c, cap), np.int32)
    for p, s in enumerate(slots):
        pid[p, :len(s)] = s
    point = torch.from_numpy(np.maximum(pid, 0).reshape(-1)).long()
    part = torch.arange(c).repeat_interleave(cap)
    codes = rb.code_choice(Xt, Ct, torch.from_numpy(centers), point, part)
    codes = codes.reshape(c, cap, m).to(torch.uint8)
    tr = None
    if tree:
        S = 3
        sup = Ct[:S].clone()
        owner = torch.cdist(Ct, sup).argmin(1)
        cmax = int(torch.bincount(owner, minlength=S).max())
        ch = -torch.ones((S, cmax), dtype=torch.int32)
        cc = torch.zeros((S, cmax, d))
        for s in range(S):
            kids = torch.nonzero(owner == s).reshape(-1)
            ch[s, :len(kids)] = kids.int()
            cc[s, :len(kids)] = Ct[kids]
        tr = ref.Tree(sup, ch, cc, S)
    st = ref.IndexState(Ct, torch.from_numpy(centers), torch.from_numpy(pid), codes, Xt, tr)
    return X, C, centers, pid, st


def test_exact_topk_matches_numpy():
    rng = np.random.default_rng(0)
    X, Q = unit(rng, 1000, 12), unit(rng, 30, 12)
    v, i = ref.exact_topk(torch.from_numpy(Q), torch.from_numpy(X), 5, block_q=7, block_x=97)
    want = np.argsort(-(Q @ X.T), axis=1, kind="stable")[:, :5]
    np.testing.assert_array_equal(i.numpy(), want)
    np.testing.assert_allclose(v.numpy(), np.take_along_axis(Q @ X.T, want, 1), rtol=1e-6)


@pytest.mark.parametrize("tree", [False, True])
def test_ann_search_probing_everything_is_exact(tree):
    """With every partition probed and every candidate reranked the
    reference search returns the exact neighbours (brute force in NumPy)."""
    rng = np.random.default_rng(1)
    X, C, _, _, st = index(rng, tree=tree)
    Q = unit(rng, 20, X.shape[1])
    ids, vals = ref.ann_search(st, torch.from_numpy(Q), top_t=C.shape[0], budget=X.shape[0], k=5)
    want = np.argsort(-(Q @ X.T), axis=1, kind="stable")[:, :5]
    np.testing.assert_array_equal(ids.numpy(), want)


def test_ann_search_window_matches_numpy():
    """At a narrow probe and budget: the probed set is the top-t of Q·Cᵀ, the
    candidates the top `budget` ids by PQ score plus the coarse term (best
    copy of a spilled id), the answer the top k of those by exact score."""
    rng = np.random.default_rng(2)
    X, C, centers, pid, st = index(rng)
    Q = unit(rng, 15, X.shape[1])
    t, budget, k = 3, 20, 5
    got, _ = ref.ann_search(st, torch.from_numpy(Q), top_t=t, budget=budget, k=k)
    m, _, s = centers.shape
    codes = st.part_codes.numpy()
    for qi, q in enumerate(Q):
        coarse = q @ C.T
        probes = np.argsort(-coarse, kind="stable")[:t]
        best = {}
        for p in probes:
            for slot, i in enumerate(pid[p]):
                if i < 0:
                    continue
                lut = np.einsum("ms,mjs->mj", q.reshape(m, s), centers)
                a = lut[np.arange(m), codes[p, slot]].sum() + coarse[p]
                best[i] = max(best.get(i, -np.inf), a)
        cand = sorted(best, key=lambda i: (-best[i], i))[:budget]
        exact = {i: float(q @ X[i]) for i in cand}
        want = sorted(cand, key=lambda i: (-exact[i], i))[:k]
        assert got[qi].tolist() == want


def test_build_choices_match_numpy():
    rng = np.random.default_rng(4)
    X, C = unit(rng, 300, 8), unit(rng, 10, 8) * 0.8
    Xt, Ct = torch.from_numpy(X), torch.from_numpy(C)
    d2 = ((X[:, None, :] - C[None]) ** 2).sum(-1)
    prim = d2.argmin(1)
    np.testing.assert_array_equal(rb.assign_choice(Xt, Ct).numpy(), prim)
    r = X - C[prim]
    rhat = r / np.linalg.norm(r, axis=1, keepdims=True)
    loss = d2 + ((rhat * X).sum(1)[:, None] - rhat @ C.T) ** 2
    loss[np.arange(300), prim] = np.inf
    spill = rb.spill_choice(Xt, Ct, torch.from_numpy(prim), 1.0)
    np.testing.assert_array_equal(spill.numpy(), loss.argmin(1))
    pairs = torch.stack([torch.from_numpy(prim), spill], 1)
    assert max(rb.pair_gaps(Xt, Ct, pairs, 1.0)) <= 1e-6
    assert max(rb.pair_gaps(Xt, Ct, pairs.flip(1), 1.0)) <= 1e-6      # either order
    same = torch.from_numpy(np.stack([prim, prim], 1))
    assert rb.pair_gaps(Xt, Ct, same, 1.0)[1] == np.inf
    W = np.stack([(prim + 1) % 10, (prim + 2) % 10], 1)
    ag, sg = rb.pair_gaps(Xt, Ct, torch.from_numpy(W), 1.0)
    rows = np.arange(300)
    a, s = np.zeros((300, 2)), np.zeros((300, 2))
    for o in (0, 1):                                   # each of the pair as primary
        p, q = W[:, o], W[:, 1 - o]
        r = X - C[p]
        rhat = r / np.linalg.norm(r, axis=1, keepdims=True)
        lo = d2 + ((rhat * X).sum(1)[:, None] - rhat @ C.T) ** 2
        lo[rows, p] = np.inf
        a[:, o] = d2[rows, p] - d2.min(1)
        s[:, o] = lo[rows, q] - lo.min(1)
    pick = np.maximum(a, s).argmin(1)
    np.testing.assert_allclose(ag, a[rows, pick].max(), rtol=1e-4)
    np.testing.assert_allclose(sg, s[rows, pick].max(), rtol=1e-4)
    assert ag > 1e-3
    skipped = torch.from_numpy(W)
    skipped[:, 1] = -1                                                # rows with a -1 are skipped
    assert rb.pair_gaps(Xt, Ct, skipped, 1.0) == (0.0, 0.0)


def test_codes_match_numpy():
    rng = np.random.default_rng(5)
    X, C = unit(rng, 200, 8), unit(rng, 6, 8) * 0.8
    centers = rng.standard_normal((4, 16, 2)).astype(np.float32) * 0.1
    point = torch.arange(200)
    part = torch.from_numpy(rng.integers(0, 6, 200))
    r = (X - C[part.numpy()]).reshape(200, 4, 2)
    want = ((r[:, :, None, :] - centers[None]) ** 2).sum(-1).argmin(-1)
    got = rb.code_choice(torch.from_numpy(X), torch.from_numpy(C), torch.from_numpy(centers),
                         point, part)
    np.testing.assert_array_equal(got.numpy(), want)
    assert rb.code_gap(torch.from_numpy(X), torch.from_numpy(C), torch.from_numpy(centers),
                       point, part, got) == 0.0


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -12, 3.14159265, -2.5e-3])
    y = tf32_round(x)
    assert y[0] == 1.0 and y[1] == 1.0 + 2 ** -10
    assert y[2] == 1.0 + 2 ** -10                   # rounds to nearest
    assert bool(((y.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((y - x).abs() / x.abs()).max()) <= 2 ** -11


def test_index_numbers_count_bad_slots():
    """Each row held twice in distinct partitions reads slot_bad 0; a row
    held once, a pair held twice and a slot out of range each count."""
    rng = np.random.default_rng(6)
    X, C, centers, pid, st = index(rng, n=200)
    point, part, slot = compare.slots(st.part_ids)
    codes = st.part_codes.reshape(-1, st.part_codes.shape[-1])[slot]
    Xt, Ct, cen = torch.from_numpy(X), torch.from_numpy(C), torch.from_numpy(centers)
    good = compare.index(Xt, Ct, cen, point, part, codes, 1.0, 2)
    assert good["slot_bad"] == 0 and good["assign_gap"] <= 1e-6 and good["code_gap"] == 0.0
    p2, q2, c2 = point.clone(), part.clone(), codes.clone()
    p2[0] = p2[1] if part[1] != part[0] else p2[2]    # one row held three times, one once
    assert compare.index(Xt, Ct, cen, p2, q2, c2, 1.0, 2)["slot_bad"] >= 2
    dup = compare.index(Xt, Ct, cen, torch.cat([point, point[:1]]), torch.cat([part, part[:1]]),
                        torch.cat([codes, codes[:1]]), 1.0, 2)
    assert dup["slot_bad"] == 1
    out = compare.index(Xt, Ct, cen, torch.cat([point, point.new_tensor([10_000])]),
                        torch.cat([part, part[:1]]), torch.cat([codes, codes[:1]]), 1.0, 2)
    assert out["slot_bad"] == 1
    ctl = compare.index_control(Xt, Ct, cen, 1.0)
    assert ctl["slot_bad"] == 0


def test_router_numbers_match_numpy():
    rng = np.random.default_rng(7)
    X, C, _, pid, st = index(rng, tree=True)
    tr = st.tree
    live = (st.part_ids >= 0).any(1)
    S = tr.supers.shape[0]
    good = rr.numbers(st.centroids, live, tr, S, tr.t_route)
    assert good == {"router_bad": 0, "router_gap": good["router_gap"]} and good["router_gap"] <= 1e-6
    d = ((C[:, None, :] - tr.supers.numpy()[None]) ** 2).sum(-1)
    ch = tr.children.clone()
    a, b = torch.nonzero(ch[0] >= 0)[0, 0], torch.nonzero(ch[1] >= 0)[0, 0]
    pa, pb = int(ch[0, a]), int(ch[1, b])
    ch[0, a], ch[1, b] = pb, pa                        # two children under each other's super
    cc = tr.child_centroids.clone()
    cc[0, a], cc[1, b] = st.centroids[pb], st.centroids[pa]
    swapped = rr.numbers(st.centroids, live, ref.Tree(tr.supers, ch, cc, tr.t_route), S, tr.t_route)
    want = max(d[pb, 0] - d[pb].min(), d[pa, 1] - d[pa].min())
    assert swapped["router_bad"] == 0
    np.testing.assert_allclose(swapped["router_gap"], want, rtol=1e-4)
    ch2 = tr.children.clone()
    ch2[0, a] = -1                                     # a live partition listed nowhere
    assert rr.numbers(st.centroids, live, ref.Tree(tr.supers, ch2, tr.child_centroids,
                                                   tr.t_route), S, tr.t_route)["router_bad"] == 1
    assert rr.numbers(st.centroids, live, tr, S + 1, tr.t_route + 1)["router_bad"] == 2
    cc2 = tr.child_centroids.clone()
    cc2[0, a, 0] += 1e-6                               # a child's row not its partition's
    assert rr.numbers(st.centroids, live, ref.Tree(tr.supers, tr.children, cc2, tr.t_route),
                      S, tr.t_route)["router_bad"] == 1
    np.testing.assert_array_equal(rr.child_choice(st.centroids, tr.supers).numpy(), d.argmin(1))


def test_distortions_match_numpy():
    rng = np.random.default_rng(8)
    X, C = unit(rng, 300, 8), unit(rng, 7, 8) * 0.8
    centers = rng.standard_normal((4, 16, 2)).astype(np.float32) * 0.1
    d2 = ((X[:, None, :] - C[None]) ** 2).sum(-1)
    Xt, Ct = torch.from_numpy(X), torch.from_numpy(C)
    np.testing.assert_allclose(rb.distortion(Xt, Ct), d2.min(1).mean(), rtol=1e-5)
    point = torch.arange(300).repeat_interleave(2)
    part = torch.from_numpy(rng.integers(0, 7, 600))
    r = (X[point.numpy()] - C[part.numpy()]).reshape(600, 4, 2)
    want = ((r[:, :, None, :] - centers[None]) ** 2).sum(-1).min(-1).sum(1).mean()
    got = rb.pq_distortion(Xt, Ct, torch.from_numpy(centers), point, part)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_kmeans_lloyd_sweeps_match_numpy():
    """From its k-means++ seeds the reference's Lloyd sweeps are NumPy's,
    and more sweeps leave its distortion no higher than the seeds'."""
    rng = np.random.default_rng(9)
    blobs = rng.standard_normal((5, 6)).astype(np.float32) * 4
    X = (blobs[rng.integers(0, 5, 2000)] + rng.standard_normal((2000, 6)).astype(np.float32) * 0.3)
    Xt = torch.from_numpy(X)[None]
    seeds = rb.kmeans(torch.Generator().manual_seed(1), Xt, 5, 0, 1e-5, 2000)[0].numpy()
    assert all(any((s == x).all() for x in X) for s in seeds)          # seeds are rows
    C = seeds.copy()
    for _ in range(3):
        a = ((X[:, None, :] - C[None]) ** 2).sum(-1).argmin(1)
        C = np.stack([X[a == j].mean(0) if (a == j).any() else C[j] for j in range(5)])
    got = rb.kmeans(torch.Generator().manual_seed(1), Xt, 5, 3, 0.0, 2000)[0].numpy()
    np.testing.assert_allclose(got, C, atol=1e-5)
    full = rb.kmeans(torch.Generator().manual_seed(1), Xt, 5, 15, 1e-5, 2000)[0]
    assert rb.distortion(torch.from_numpy(X), full) <= rb.distortion(torch.from_numpy(X),
                                                                     torch.from_numpy(seeds))


def test_reference_training_is_fixed_by_the_seed():
    rng = np.random.default_rng(10)
    X = torch.from_numpy(unit(rng, 1500, 8))
    a = rb.train_codebook(3, X, 6, 1000)
    assert torch.equal(a, rb.train_codebook(3, X, 6, 1000))
    point = torch.arange(1500)
    part = rb.assign_choice(X, a)
    pq = rb.train_pq(3, X, a, point, part, 4)
    assert pq.shape == (4, 16, 2) and torch.equal(pq, rb.train_pq(3, X, a, point, part, 4))
