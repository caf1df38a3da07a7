"""The port's CUDA kernels and slices on the card (marker `cuda`).

Each kernel is held against its plain PyTorch version on CUDA tensors,
and the build + search slice, the tree-routed filtered search and the
serving slice (online inserts, the pruned router, the delta pack, the host
engine), snapshots and log replay onto the card, the KMR curve, the
front-end's coalesced ≡ solo guarantee, tenant bitmaps, replica fan-out,
the kNN memory, the shard-parallel search and the LM serving path (every
architecture's smoke config) on the card against the same slices on the
CPU (which tests/test_torch_slice.py, test_torch_router.py,
test_torch_filtered.py, test_torch_durability.py, test_torch_kmr.py,
test_torch_frontend.py, test_torch_knn_memory.py,
test_torch_distributed.py, test_torch_models.py and
test_torch_lm_serve.py hold against the JAX package); the static
analyzer's contracts are traced on the card over the kernels
(repro_torch.analysis: the CLI, the device-to-host rule, Lloyd's (n,)
vectors, search tiles under torch's sync check); and LM training: a
train step of every smoke config on the card against the CPU,
accumulation, resume bit for bit, the compressed all-reduce of CUDA
tensors over gloo, and no fallback to the CPU; the sharded LM: the op
counter on CUDA DTensors and sharded serving on a one-rank gloo mesh
against the plain path. This file imports
nothing of JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

Without a card every test skips.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert, spans  # noqa: E402
from repro_torch.ckpt import load_snapshot, save_snapshot  # noqa: E402
from repro_torch.core import (build_ivf, build_ivf_sharded, kmr_curve,  # noqa: E402
                              pack_ivf, rank_statistics, recall_at_k,
                              search_jit_batched, true_neighbors)
from repro_torch.core import kmeans  # noqa: E402
from repro_torch.core.kmeans import train_kmeans  # noqa: E402
from repro_torch.core.mutable import MutableIVF  # noqa: E402
from repro_torch.core import search as search_mod  # noqa: E402
from repro_torch.core.router import FlatRouter, TreeRouter  # noqa: E402
from repro_torch.core.search import search_numpy  # noqa: E402
from repro_torch.core.soar import naive_spill_assign  # noqa: E402
from repro_torch.data.vectors import make_manifold  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import kmeans_pp as kmeans_pp_mod  # noqa: E402
from repro_torch.kernels import lloyd as lloyd_mod  # noqa: E402
from repro_torch.kernels.kmeans_pp import kmeans_pp  # noqa: E402
from repro_torch.kernels.int8_rerank import int8_rerank  # noqa: E402
from repro_torch.kernels.lloyd import lloyd_sweep  # noqa: E402
from repro_torch.kernels.pq_score import (pq_score, pq_score_probes,  # noqa: E402
                                          pq_score_probes_select)
from repro_torch.kernels.soar_assign import assign_fused, soar_assign  # noqa: E402
from repro_torch.kernels.tree_route import tree_route  # noqa: E402
from repro_torch.kernels.vq_assign import vq_assign  # noqa: E402
from repro_torch.quant.anisotropic import anisotropic_assign, eta_from_threshold  # noqa: E402
from repro_torch.quant.int8 import Int8Data, int8_dequantize, int8_quantize  # noqa: E402
from repro_torch.core import distributed as dist_mod  # noqa: E402
from repro_torch.core.distributed import make_replicated_search  # noqa: E402
from repro_torch.core.search import pad_queries  # noqa: E402
from repro_torch.serve.api import SearchParams  # noqa: E402
from repro_torch.serve.engine import AnnEngine  # noqa: E402
from repro_torch.serve.frontend import ServingFrontend, TenantFilterBank  # noqa: E402
from repro_torch.serve.knn_memory import KNNMemory  # noqa: E402

import filtered_ref as fr  # noqa: E402
from torch_recall import assert_recall_means_close  # noqa: E402

pytestmark = pytest.mark.cuda


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def probe_case(nq, t, c, pmax, m, seed=0):
    """Seeded numpy inputs of the probe scorer: a packed (c, pmax, m) table
    with ragged sizes (partition 0 empty, partition c-1 full), probes that
    repeat within row 0 and reach partitions 0 and c-1, and a starved
    probe (partition 0 at -inf) in the last row."""
    rng = np.random.default_rng(seed)
    luts = rng.standard_normal((nq, m, 16)).astype(np.float32)
    codes = rng.integers(0, 16, (c, pmax, m)).astype(np.uint8)
    sizes = rng.integers(0, pmax + 1, c).astype(np.int32)
    sizes[0], sizes[c - 1] = 0, pmax
    parts = rng.integers(0, c, (nq, t)).astype(np.int64)
    parts[0, 0] = c - 1
    if t > 1:
        parts[0, 1] = parts[0, 0]
    psc = rng.standard_normal((nq, t)).astype(np.float32)
    parts[-1, -1], psc[-1, -1] = 0, -np.inf
    return luts, codes, sizes, parts, psc


def select_case(nq, t, c, pmax, m, seed=0):
    """`probe_case`'s inputs, plus part_ids (c, pmax) int32 and an (n,)
    uint8 filter for the selecting scorer. Ids are unique over the table,
    -1 past each extent and at one tombstone inside each extent of more
    than one row (never its last slot). Partition c-1 (full) holds one
    code in every row, and row 0's first two probes (both c-1) lie far
    above every other slot, so a cut of row 0 below its live slots falls
    inside a run of ties; row 1's first probe is c-1, starved (-inf). The
    filter passes about half the ids."""
    luts, codes, sizes, parts, psc = probe_case(nq, t, c, pmax, m, seed)
    rng = np.random.default_rng(seed + 1)
    codes[c - 1] = codes[c - 1, 0]
    ids = np.arange(c * pmax, dtype=np.int32).reshape(c, pmax)
    ids[np.arange(pmax)[None, :] >= sizes[:, None]] = -1
    for p in range(c):
        if sizes[p] > 1:
            ids[p, rng.integers(0, sizes[p] - 1)] = -1
    psc[0, :2] = 1000.0
    if nq > 1:
        parts[1, 0], psc[1, 0] = c - 1, -np.inf
    bits = (rng.random(c * pmax) < 0.5).astype(np.uint8)
    return luts, codes, sizes, parts, psc, ids, bits


# the CPU cases of test_torch_kernels.py, then a search tile (nq = 128) at
# t = 1, 40 (the flat probe) and 80 (its escalation), partitions of up to
# 1,506 rows (odd pmax: every head alignment), m = 160, and m = 25 (the
# shard-parallel dry run's d / 4, read a byte at a time) at c = 2,500
@pytest.mark.parametrize("nq,t,c,pmax,m", [
    (3, 4, 6, 7, 5), (8, 5, 10, 33, 16), (4, 3, 5, 40, 50), (5, 2, 4, 1, 16),
    (2, 1, 3, 9, 50), (6, 6, 12, 20, 5),
    (128, 1, 50, 1501, 50), (128, 40, 200, 1506, 50), (128, 80, 200, 1501, 50),
    (7, 9, 30, 333, 160), (16, 7, 9, 13, 25), (128, 40, 2500, 801, 25)])
def test_pq_score_probes_matches_plain(cuda, nq, t, c, pmax, m):
    args = [torch.from_numpy(a).to(cuda) for a in probe_case(nq, t, c, pmax, m)]
    n0 = pq_score_probes.launches
    got = pq_score_probes(*args)
    torch.cuda.synchronize()
    assert pq_score_probes.launches == n0 + 1
    want = ref.pq_score_probes_ref(*args)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    assert bool(torch.isfinite(got[fin]).all())
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-5)


# (nq, t, c, pmax, m, keep): a glove tile (m 50, read 2 bytes at a time),
# a deep10m tile (m 48, 4 at a time, 164 probes), the shard's odd m 25 (1 at
# a time), keep at the scorer's limit, keep above a narrow window, and the
# small CPU cases; integer LUTs and coarse scores make every sum exact in
# any order, so slots tie often and the plain version's bits are the
# kernel's, ties at the cut and all
SELECT_CARD_CASES = [(128, 40, 200, 1441, 50, 512), (128, 164, 400, 1400, 48, 512),
                     (64, 40, 300, 801, 25, 512), (16, 30, 50, 333, 16, 2048),
                     (8, 5, 10, 33, 16, 300), (3, 4, 6, 7, 5, 5), (5, 2, 4, 1, 16, 7),
                     (2, 9, 30, 50, 7, 2048)]


@pytest.mark.parametrize("filtered", [False, True], ids=["all", "filter"])
@pytest.mark.parametrize("nq,t,c,pmax,m,keep", SELECT_CARD_CASES)
def test_pq_score_probes_select_is_its_plain_versions_bits(cuda, nq, t, c, pmax, m, keep,
                                                           filtered):
    luts, codes, sizes, parts, psc, ids, bits = select_case(nq, t, c, pmax, m)
    luts, psc = np.round(luts * 4), np.round(psc * 4)
    args = [torch.from_numpy(a).to(cuda) for a in (luts, codes, sizes, parts, psc, ids)]
    filt = torch.from_numpy(bits).to(cuda) if filtered else None
    n0 = (pq_score_probes_select.launches, pq_score_probes.launches)
    got_i, got_v = pq_score_probes_select(*args, keep, filt)
    torch.cuda.synchronize()
    assert (pq_score_probes_select.launches, pq_score_probes.launches) == (n0[0] + 1, n0[1])
    want_i, want_v = ref.pq_score_probes_select_ref(*args, keep, filt)
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
    assert int((got_i[0] >= 0).sum()) == min(keep, int((want_v[0] > float("-inf")).sum()))


def test_pq_score_probes_select_refuses_what_it_cannot_hold(cuda):
    args = [torch.from_numpy(a).to(cuda) for a in select_case(2, 3, 4, 5, 4)[:6]]
    n0 = pq_score_probes_select.launches
    for keep in (0, 2049):
        with pytest.raises(ValueError, match="holds"):
            pq_score_probes_select(*args, keep)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pq_score_probes_select(*args[:5], args[5].to("meta"), 4)
    assert pq_score_probes_select.launches == n0


@pytest.mark.parametrize("router", ["flat", "tree"])
@pytest.mark.parametrize("mode", ["plain", "budget"])
def test_search_through_the_select_on_card_is_the_window_paths_bits(cuda, monkeypatch,
                                                                    router, mode):
    """`search_jit_batched` on the card through the selecting scorer gives
    the window path's bits (both score every slot with the same sum), at
    both routers, unfiltered and under `escalate="budget"` at 1%; the
    select path launches the selecting scorer and never the window form."""
    ds = make_manifold(0, 20_000, 32, nq=256, device="cpu")
    idx = build_ivf_sharded(torch.Generator().manual_seed(0), ds.X, 64, pq_subspaces=8,
                            device="cpu", router="tree")
    packed = pack_ivf(_to(idx, cuda))
    rt = FlatRouter(packed.centroids) if router == "flat" else packed.router
    bits = None
    if mode == "budget":
        bits = (torch.rand(20_000, generator=torch.Generator().manual_seed(1))
                < 0.01).to(torch.uint8)
    kw = dict(top_t=8, final_k=10, rerank_budget=64, bq=128, router=rt, filter=bits,
              escalate="budget" if mode == "budget" else False)
    Q = ds.Q.to(cuda)
    n0 = (pq_score_probes_select.launches, pq_score_probes.launches)
    si, sv = search_jit_batched(packed, Q, **kw)
    torch.cuda.synchronize()
    assert pq_score_probes_select.launches > n0[0] and pq_score_probes.launches == n0[1]
    with monkeypatch.context() as mp:
        mp.setattr(search_mod, "select_fits", lambda keep, m: False)
        wi, wv = search_jit_batched(packed, Q, **kw)
    torch.cuda.synchronize()
    assert pq_score_probes.launches > n0[1]
    assert torch.equal(sv, wv)
    fin = torch.isfinite(wv)
    assert torch.equal(si[fin], wi[fin]) and bool((si[~fin] == -1).all())
    assert float(fin.float().mean()) > 0.9


def int8_case(nq, B, n, d, seed=0, integer=True):
    """Q, int8 rows with scales, candidate ids and PQ scores for the int8
    rerank: integer Q in [-8, 8] makes every ⟨q, x₈⟩ an exact f32 sum, so
    the kernel's and the plain version's scores are the same bits in any
    order (ties included); else unit-norm queries."""
    rng = np.random.default_rng(seed)
    Q = (rng.integers(-8, 9, (nq, d)) if integer else rng.standard_normal((nq, d)))
    Q = Q.astype(np.float32)
    if not integer:
        Q /= np.linalg.norm(Q, axis=1, keepdims=True)
    q = rng.integers(-127, 128, (n, d)).astype(np.int8)
    scale = (rng.random(n) * 0.01 + 1e-3).astype(np.float32)
    ids = rng.integers(0, n, (nq, B)).astype(np.int32)
    approx = rng.standard_normal((nq, B)).astype(np.float32)
    approx[rng.random((nq, B)) < 0.05] = -np.inf          # the dedup's dropped slots
    return Q, q, scale, ids, approx


@pytest.mark.parametrize("nq,B,n,d,k", [(128, 256, 200_000, 100, 10),   # glove's tile
                                        (128, 256, 50_000, 96, 10),
                                        (37, 200, 5_000, 30, 10),       # bytes, not words
                                        (3, 7, 100, 8, 10),             # B < k
                                        (16, 2048, 10_000, 100, 64)])
def test_int8_rerank_is_its_plain_versions_bits(cuda, nq, B, n, d, k):
    Q, q, scale, ids, approx = (torch.from_numpy(a).to(cuda)
                                for a in int8_case(nq, B, n, d))
    rows = Int8Data(q, scale)
    n0 = int8_rerank.launches
    gi, gv = int8_rerank(Q, rows, ids, approx, k)
    torch.cuda.synchronize()
    assert int8_rerank.launches == n0 + 1
    wi, wv = ref.int8_rerank_ref(Q, q, scale, ids, approx, k)
    assert torch.equal(gv, wv) and torch.equal(gi, wi)


def test_int8_rerank_on_glove_tiles_within_f32_rounding(cuda):
    """Unit queries at glove's tile: scores within f32 rounding of the
    plain version's (another order of the sum), the same ids wherever no
    score lies within that rounding of its neighbour's."""
    Q, q, scale, ids, approx = (torch.from_numpy(a).to(cuda)
                                for a in int8_case(128, 256, 1_183_514, 100, 3, False))
    gi, gv = int8_rerank(Q, Int8Data(q, scale), ids, approx, 11)
    wi, wv = ref.int8_rerank_ref(Q, q, scale, ids, approx, 11)
    torch.testing.assert_close(gv, wv, rtol=1e-5, atol=1e-7)
    tol = 1e-5 * wv.abs()
    near = torch.zeros_like(wv, dtype=torch.bool)
    near[:, 1:] |= (wv[:, 1:] - wv[:, :-1]).abs() <= tol[:, 1:]
    near[:, :-1] |= (wv[:, :-1] - wv[:, 1:]).abs() <= tol[:, :-1]
    clear = ~near[:, :10]
    assert float(clear.float().mean()) > 0.9
    assert torch.equal(gi[:, :10][clear], wi[:, :10][clear])


def test_int8_rerank_refuses_what_it_cannot_take(cuda):
    Q, q, scale, ids, approx = (torch.from_numpy(a).to(cuda) for a in int8_case(2, 5, 10, 8))
    n0 = int8_rerank.launches
    with pytest.raises(ValueError):
        int8_rerank(Q, Int8Data(q, scale), ids.long(), approx, 3)
    with pytest.raises(ValueError):
        int8_rerank(Q, Int8Data(q, scale), ids, approx[:, :4], 3)
    with pytest.raises(ValueError):
        int8_rerank(Q.cpu(), Int8Data(q, scale), ids, approx, 3)
    assert int8_rerank.launches == n0


def test_the_f32_rerank_is_the_parents_bits_on_a_glove_tile(cuda):
    """The f32 index's rerank on the card, at glove's width, budget and
    tile, is the parent's composition bit for bit: a product over the
    gathered rows, −inf where the PQ score is, a stable top k and the
    ids' gather; the int8 kernel never launches."""
    ds = make_manifold(0, 60_000, 100, nq=128, device="cpu")
    idx = build_ivf_sharded(torch.Generator().manual_seed(0), ds.X, 100, pq_subspaces=50,
                            device=cuda)
    packed = pack_ivf(idx)
    assert packed.rerank.dtype == torch.float32
    Q = ds.Q.to(cuda)
    bi, bv = [], []
    real = search_mod.dedup_ranked

    def keep(*a):
        out = real(*a)
        bi.append(out[0])
        bv.append(out[1])
        return out
    n0 = int8_rerank.launches
    search_mod.dedup_ranked = keep
    try:
        fi, fv = search_jit_batched(packed, Q, top_t=40, final_k=10, rerank_budget=256, bq=128)
    finally:
        search_mod.dedup_ranked = real
    assert int8_rerank.launches == n0 and len(bi) == 1
    exact = torch.einsum("qbd,qd->qb", packed.rerank[bi[0].clamp(min=0).to(torch.int64)], Q)
    exact = torch.where(torch.isfinite(bv[0]), exact, float("-inf"))
    v, pos = torch.sort(exact, dim=-1, descending=True, stable=True)
    assert torch.equal(fv, v[:, :10]) and torch.equal(fi, torch.gather(bi[0], -1, pos[:, :10]))


def test_the_int8_index_serves_through_the_kernel_on_card(cuda):
    """An int8 index behind `AnnEngine` on the card: its rows stay int8,
    the rerank launches the kernel once a tile, and the answers are the
    CPU's plain path's, to the rounding of the kernel's sum order."""
    ds = make_manifold(1, 20_000, 32, nq=300, device="cpu")
    kw = dict(spill_mode="soar", n_spills=2, anisotropic_T=0.2, rerank="int8",
              pq_subspaces=8, train_sample=8192, shard_size=4096)
    idx = build_ivf_sharded(torch.Generator().manual_seed(0), ds.X, 64, device="cpu", **kw)
    card = AnnEngine(MutableIVF.from_index(_to(idx, cuda)), top_t=8, rerank_budget=64, bq=64)
    host = AnnEngine(MutableIVF.from_index(idx), top_t=8, rerank_budget=64, bq=64)
    assert isinstance(card.index.rerank, Int8Data) and card.index.rerank.q.is_cuda
    n0 = int8_rerank.launches
    rc = card.search_request(ds.Q.numpy(), SearchParams(k=10))
    assert int8_rerank.launches == n0 + 5                   # 300 queries: 5 tiles of 64
    rh = host.search_request(ds.Q.numpy(), SearchParams(k=10))
    assert (rc.ids == rh.ids).mean() >= 0.99
    np.testing.assert_allclose(rc.scores, rh.scores, rtol=1e-5, atol=1e-6)
    new = card.add(ds.X[:100].numpy() * 0.5)
    want = int8_quantize(ds.X[:100].to(cuda) * 0.5)
    assert torch.equal(card.index.rerank.q[torch.from_numpy(new).long()], want.q)


def test_pq_score_probes_refuses_a_misaligned_table(cuda):
    luts, codes, sizes, parts, psc = (torch.from_numpy(a).to(cuda)
                                      for a in probe_case(2, 3, 4, 5, 4))
    shifted = torch.zeros(codes.numel() + 1, dtype=torch.uint8, device=cuda)[1:]
    with pytest.raises(ValueError, match="16-byte"):
        pq_score_probes(luts, shifted.view(codes.shape), sizes, parts, psc)


def test_pq_score_probes_refuses_meta_mixed_with_cuda(cuda):
    """A dry run's meta tensor never reaches a launch: mixed with CUDA
    tensors, the wrapper raises and launches nothing."""
    luts, codes, sizes, parts, psc = (torch.from_numpy(a).to(cuda)
                                      for a in probe_case(2, 3, 4, 5, 4))
    n0 = pq_score_probes.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        pq_score_probes(luts.to("meta"), codes, sizes, parts, psc)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pq_score_probes(luts, codes.to("meta"), sizes, parts, psc)
    assert pq_score_probes.launches == n0


@pytest.mark.parametrize("n,c,d", [(100, 16, 32), (513, 100, 64),
                                   (64, 2000, 100), (1000, 777, 20), (70, 3, 5),
                                   (700, 33, 13),       # d % 4 != 0: 4-byte copies
                                   (300, 50, 1536),     # X and r-hat streamed in the ring
                                   (257, 130, 128),     # soar resident at its limit, vq streamed
                                   (300, 40, 150),      # both streamed
                                   (300, 1, 12),        # c = 1: soar has no column left
                                   (500, 2, 24),        # c = 2
                                   (65_537, 500, 100)])  # ragged last block
def test_assign_kernels_match_plain(cuda, n, c, d):
    X = torch.from_numpy(_normal(62, n, d)).to(cuda)
    C = torch.from_numpy(_normal(63, c, d)).to(cuda)
    gidx, gval = vq_assign(X, C)
    widx, wval = ref.vq_assign_ref(X, C)
    torch.cuda.synchronize()
    assert float((gidx == widx).float().mean()) >= 0.999
    torch.testing.assert_close(gval, wval, rtol=1e-4, atol=1e-4)
    r = X - C[widx.long()]
    rhat = r / torch.linalg.vector_norm(r, dim=-1, keepdim=True).clamp(min=1e-12)
    for lam in (0.0, 1.0, 1.5):
        sidx, sval = soar_assign(X, rhat, widx, C, lam)
        ridx, rval = ref.soar_assign_ref(X, rhat, widx, C, lam)
        assert float((sidx == ridx).float().mean()) >= 0.999
        torch.testing.assert_close(sval, rval, rtol=1e-4, atol=1e-4)
        if c == 1:    # only the primary: index 0 and +inf, as the plain version
            assert bool((sidx == 0).all()) and bool(torch.isposinf(sval).all())
        else:
            assert not bool((sidx == widx).any())


def test_assign_kernels_repeat_bitwise(cuda):
    X = torch.from_numpy(_normal(76, 5000, 100)).to(cuda)
    C = torch.from_numpy(_normal(77, 2000, 100)).to(cuda)
    idx, val = vq_assign(X, C)
    again = vq_assign(X, C)
    assert torch.equal(again[0], idx) and torch.equal(again[1], val)
    r = X - C[idx.long()]
    rhat = r / torch.linalg.vector_norm(r, dim=-1, keepdim=True).clamp(min=1e-12)
    sidx, sval = soar_assign(X, rhat, idx, C, 1.0)
    again = soar_assign(X, rhat, idx, C, 1.0)
    assert torch.equal(again[0], sidx) and torch.equal(again[1], sval)


@pytest.mark.parametrize("n,c,d", [(128, 64, 16), (300, 130, 48), (4000, 2000, 100)])
def test_soar_assign_lam0_is_naive_spill_on_card(cuda, n, c, d):
    X = torch.from_numpy(_normal(78, n, d)).to(cuda)
    C = torch.from_numpy(_normal(79, c, d)).to(cuda)
    prim, _ = vq_assign(X, C)
    r = X - C[prim.long()]
    rhat = r / torch.linalg.vector_norm(r, dim=-1, keepdim=True).clamp(min=1e-12)
    sidx, _ = soar_assign(X, rhat, prim, C, 0.0)
    want = naive_spill_assign(X, C, prim)
    assert float((sidx == want).float().mean()) >= 0.999


@pytest.mark.parametrize("d", [100, 6])
def test_assign_ties_go_to_the_lowest_index(cuda, d):
    """Duplicate centroids score alike: vq never picks the higher copies,
    and the spill of a row whose primary is the lowest copy goes to the
    next copy (at lam = 0 always), never to the highest."""
    X = torch.from_numpy(_normal(80, 3000, d)).to(cuda)
    C = X[:40].clone() + 0.01
    C[31] = C[3]
    C[39] = C[3]
    idx, _ = vq_assign(X, C)
    assert int((idx == 3).sum()) > 0 and not bool(((idx == 31) | (idx == 39)).any())
    assert torch.equal(idx, ref.vq_assign_ref(X, C)[0])
    r = X - C[idx.long()]
    rhat = r / torch.linalg.vector_norm(r, dim=-1, keepdim=True).clamp(min=1e-12)
    for lam in (0.0, 1.0):
        sidx, _ = soar_assign(X, rhat, idx, C, lam)
        assert not bool((sidx == 39).any())
        assert not bool(((sidx == 31) & (idx != 3)).any())
        if lam == 0.0:
            assert bool((sidx[idx == 3] == 31).all())
        assert float((sidx == ref.soar_assign_ref(X, rhat, idx, C, lam)[0]).float().mean()) >= 0.999


@pytest.mark.parametrize("n,c,d", [(1000, 16, 8), (3000, 64, 32), (5000, 300, 100),
                                   (2000, 45, 100),    # the tree router's k-means
                                   (100, 7, 16),       # n < 128: one ragged block
                                   (300, 1, 12),       # c = 1
                                   (700, 33, 13),      # d % 4 != 0: 4-byte copies
                                   (600, 20, 150),     # d = 150: too deep to stay resident
                                   (600, 20, 1024),    # d = 1024: X streamed in the ring
                                   (4000, 2000, 100)])  # the codebook's c and d
def test_lloyd_sweep_matches_plain_and_repeats(cuda, n, c, d):
    X = torch.from_numpy(_normal(64, n, d)).to(cuda)
    C = X[:c].clone() + 0.01
    gC, gcnt, gdist = lloyd_sweep(X, C)
    wC, wcnt, wdist = ref.lloyd_sweep_ref(X, C)
    torch.testing.assert_close(gcnt, wcnt, rtol=0, atol=0)
    torch.testing.assert_close(gC, wC, rtol=1e-5, atol=1e-6)
    assert abs(float(gdist) - float(wdist)) <= 1e-5 * abs(float(wdist))
    again = lloyd_sweep(X, C)
    assert all(torch.equal(a, b) for a, b in zip(again, (gC, gcnt, gdist)))


def test_lloyd_sweep_keeps_empty_centroid(cuda):
    X = torch.from_numpy(_normal(65, 200, 6)).to(cuda)
    C = torch.cat([X[:4], torch.full((1, 6), 50.0, device=cuda)])
    gC, gcnt, _ = lloyd_sweep(X, C)
    assert float(gcnt[4]) == 0.0 and torch.equal(gC[4], C[4])


@pytest.mark.parametrize("d", [100, 6])
def test_lloyd_sweep_ties_go_to_the_lowest_index(cuda, d):
    """Duplicate centroids score alike: every row picks the lower index, so
    the higher duplicate stays empty and keeps its old centroid."""
    X = torch.from_numpy(_normal(73, 3000, d)).to(cuda)
    C = X[:40].clone() + 0.01
    C[31] = C[3]
    C[39] = C[3]
    idx, _ = lloyd_mod.assign_phase(X, C)
    assert int((idx == 3).sum()) > 0 and not bool(((idx == 31) | (idx == 39)).any())
    gC, gcnt, _ = lloyd_sweep(X, C)
    torch.testing.assert_close(gcnt, ref.lloyd_sweep_ref(X, C)[1], rtol=0, atol=0)
    assert float(gcnt[31]) == float(gcnt[39]) == 0.0
    assert torch.equal(gC[31], C[31]) and torch.equal(gC[39], C[39])


@pytest.mark.parametrize("n,c,d", [(3000, 64, 32), (2049, 100, 20), (70_000, 2000, 100),
                                   (5000, 50_000, 8)])   # counters past shared memory
def test_lloyd_group_phase_sums_rows_in_row_order(cuda, n, c, d):
    """Given the assignment, the grouping and sums give the bits of a
    float32 sum of each centroid's rows in row order (numpy's unbuffered
    add.at), over the mean: the order of the previous per-centroid scan."""
    Xn = _normal(74, n, d)
    Cn = _normal(75, c, d)
    X, C = torch.from_numpy(Xn).to(cuda), torch.from_numpy(Cn).to(cuda)
    idx, mind = lloyd_mod.assign_phase(X, C)
    gC, gcnt, gdist = lloyd_mod.group_phase(X, C, idx, mind)
    ii = idx.cpu().numpy().astype(np.int64)
    sums = np.zeros((c, d), np.float32)
    np.add.at(sums, ii, Xn)
    cnt = np.bincount(ii, minlength=c).astype(np.float32)
    want = np.where(cnt[:, None] > 0, sums / np.maximum(cnt, 1)[:, None], Cn)
    np.testing.assert_array_equal(gcnt.cpu().numpy(), cnt)
    np.testing.assert_array_equal(gC.cpu().numpy(), want)
    m = mind.cpu().numpy().astype(np.float64)
    assert abs(float(gdist) - m.mean()) <= 1e-6 * abs(m.mean())


def test_wrapper_refuses_mixed_devices(cuda):
    with pytest.raises(ValueError, match="CUDA tensors"):
        vq_assign(torch.zeros((4, 3), device=cuda), torch.zeros((2, 3)))


def test_route_and_dense_wrappers_refuse_mixed_devices(cuda):
    with pytest.raises(ValueError, match="CUDA tensors"):
        tree_route(torch.zeros((4, 3), device=cuda), torch.zeros((2, 3), device=cuda),
                   torch.zeros((2, 1, 3)), torch.zeros((2, 1), dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pq_score(torch.zeros((2, 3, 16)), torch.zeros((5, 3), dtype=torch.uint8,
                                                      device=cuda))


def _tree_tables(seed, S, cmax, d, frac_pad=0.25):
    """Random router tables with ragged children (-1 pad, as training makes)."""
    rng = np.random.default_rng(seed)
    SC = rng.standard_normal((S, d)).astype(np.float32)
    CC = rng.standard_normal((S, cmax, d)).astype(np.float32)
    pad = rng.uniform(size=(S, cmax)) < frac_pad
    pad[:, 0] = False
    CH = np.where(pad, -1, np.arange(S * cmax).reshape(S, cmax)).astype(np.int32)
    CC[pad] = 0.0
    return SC, CC, CH


@pytest.mark.parametrize("nq,S,cmax,d,tr", [
    (1, 4, 3, 8, 1), (7, 16, 9, 32, 3),
    (40, 8, 16, 16, 8),         # t_route = S
    (130, 32, 5, 24, 4),
    (300, 45, 120, 100, 6),     # the main path's tree: S = 45, t_route = 6
    (5, 20_000, 2, 16, 5),      # scores above 48 KB of shared memory
    (128, 181, 256, 100, 23),   # c = 32,768 at the router's defaults
    (37, 45, 62, 100, 6),       # the main path's tables, a ragged tile
    (9, 45, 62, 100, 45),       # t_route = S with padded children
    (11, 10, 7, 13, 3),         # d % 4 != 0: rows read a float at a time
])
def test_tree_route_matches_plain(cuda, nq, S, cmax, d, tr):
    Q = torch.from_numpy(_normal(68, nq, d)).to(cuda)
    SC, CC, CH = (torch.from_numpy(a).to(cuda) for a in _tree_tables(69, S, cmax, d))
    n0 = tree_route.launches
    gs, gi = tree_route(Q, SC, CC, CH, tr)
    torch.cuda.synchronize()
    assert tree_route.launches == n0 + 1
    ws, wi = ref.tree_route_ref(Q, SC, CC, CH, tr)
    # random normals: no near-ties between supers, so the ids are equal
    assert torch.equal(gi, wi)
    assert torch.equal(torch.isfinite(gs), torch.isfinite(ws))
    assert torch.equal(torch.isfinite(gs), gi >= 0)
    fin = torch.isfinite(ws)
    torch.testing.assert_close(gs[fin], ws[fin], rtol=1e-4, atol=1e-4)


def test_tree_route_misaligned_queries_and_repeats(cuda):
    nq, S, cmax, d, tr = 19, 45, 62, 100, 6
    buf = torch.from_numpy(_normal(73, nq * d + 1)).to(cuda)
    Q = buf[1:].view(nq, d)                # contiguous, 4 bytes past 16-byte alignment
    SC, CC, CH = (torch.from_numpy(a).to(cuda) for a in _tree_tables(74, S, cmax, d))
    gs, gi = tree_route(Q, SC, CC, CH, tr)
    ws, wi = ref.tree_route_ref(Q, SC, CC, CH, tr)
    assert torch.equal(gi, wi)
    fin = torch.isfinite(ws)
    torch.testing.assert_close(gs[fin], ws[fin], rtol=1e-4, atol=1e-4)
    Qa = Q.clone()
    a = tree_route(Qa, SC, CC, CH, tr)
    b = tree_route(Qa, SC, CC, CH, tr, checked=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))   # two calls, the same bits


def test_tree_route_nan_supers_come_last(cuda):
    # NaN scores are taken after every number, the lowest index first
    SC = torch.tensor([[1.0], [float("nan")], [3.0], [float("nan")], [2.0]], device=cuda)
    CC = torch.ones((5, 1, 1), device=cuda)
    CH = torch.arange(5, dtype=torch.int32, device=cuda).reshape(5, 1)
    _, ids = tree_route(torch.ones((2, 1), device=cuda), SC, CC, CH, 5)
    assert ids.cpu().tolist() == [[2, 4, 0, 1, 3]] * 2


def test_tree_router_checks_its_tables_once(cuda):
    SC, CC, CH = (torch.from_numpy(a).to(cuda) for a in _tree_tables(75, 45, 62, 32))
    rt = TreeRouter(SC, CH, CC, 6, 45 * 62)
    Q = torch.from_numpy(_normal(76, 50, 32)).to(cuda)
    got = rt.route(Q, 20)
    want = TreeRouter(SC.cpu(), CH.cpu(), CC.cpu(), 6, 45 * 62).route(Q.cpu(), 20)
    assert torch.equal(got[1].cpu(), want[1])
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        TreeRouter(SC, CH.cpu(), CC, 6, 45 * 62)      # mixed devices refused when built
    with pytest.raises(ValueError, match="int32"):
        TreeRouter(SC, CH.long(), CC, 6, 45 * 62)


def test_tree_route_ties_and_oversized_supers(cuda):
    SC = torch.ones((5, 4), device=cuda)
    CC = torch.from_numpy(_normal(70, 5, 2, 4)).to(cuda)
    CH = torch.arange(10, dtype=torch.int32, device=cuda).reshape(5, 2)
    _, ids = tree_route(torch.ones((3, 4), device=cuda), SC, CC, CH, 3)
    assert torch.equal(ids.cpu(), torch.arange(6, dtype=torch.int32).repeat(3, 1))
    S = 60_000                   # 60,000 scores do not fit in shared memory
    with pytest.raises(ValueError, match="shared memory"):
        tree_route(torch.ones((1, 4), device=cuda), torch.ones((S, 4), device=cuda),
                   torch.ones((S, 1, 4), device=cuda),
                   torch.zeros((S, 1), dtype=torch.int32, device=cuda), 1)


@pytest.mark.parametrize("nq,n,m", [(1, 64, 8), (7, 300, 16), (128, 512, 16),
                                    (33, 1000, 4), (2, 2048, 32), (9, 70_001, 50),
                                    (3, 100, 200),    # (3, 100, 200): > 48 KB
                                    (128, 70_001, 50),  # two groups of 64 queries
                                    (65, 5_000, 50),    # a group of one query
                                    (200, 10_000, 24), (5, 3_000, 7),
                                    (3, 3_000_001, 50)])  # many tiles a block
def test_pq_score_matches_plain(cuda, nq, n, m):
    luts = torch.from_numpy(_normal(71, nq, m, 16)).to(cuda)
    codes = torch.from_numpy(np.random.default_rng(72).integers(
        0, 16, (n, m)).astype(np.uint8)).to(cuda)
    n0 = pq_score.launches
    got = pq_score(luts, codes)
    torch.cuda.synchronize()
    assert pq_score.launches == n0 + 1
    torch.testing.assert_close(got, ref.pq_score_ref(luts, codes), rtol=1e-5, atol=1e-5)


def test_pq_score_widest_m_sums_exactly(cuda):
    # quarter-integer LUT entries: every partial sum is exact in f32, so
    # the kernel's in-order sums equal the plain version's bit for bit
    nq, n, m = 130, 1_000, 363             # the widest m whose ring fits
    rng = np.random.default_rng(79)
    luts = torch.from_numpy((rng.integers(-32, 33, (nq, m, 16)) / 4).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, 16, (n, m)).astype(np.uint8))
    got = pq_score(luts.to(cuda), codes.to(cuda))
    assert torch.equal(got.cpu(), ref.pq_score_ref(luts, codes))


def test_pq_score_repeats_and_takes_any_alignment(cuda):
    nq, n, m = 70, 20_000, 50
    luts = torch.from_numpy(_normal(77, nq, m, 16)).to(cuda)
    table = torch.from_numpy(np.random.default_rng(78).integers(
        0, 16, (n + 1, m)).astype(np.uint8)).to(cuda)
    codes = table[1:]                    # 50 bytes past 16-byte alignment
    got = pq_score(luts, codes)
    assert torch.equal(pq_score(luts, codes), got)      # two calls, the same bits
    torch.testing.assert_close(got, ref.pq_score_ref(luts, codes), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="shared memory"):
        pq_score(torch.zeros((1, 364, 16), device=cuda),
                 torch.zeros((4, 364), dtype=torch.uint8, device=cuda))


def _to(idx, device):
    """The port's IVFIndex, its tree router and int8 rows included, moved
    to another device."""
    fields = {
        "centroids": idx.centroids.cpu().numpy(), "starts": idx.starts.cpu().numpy(),
        "point_ids": idx.point_ids.cpu().numpy(), "codes": idx.codes.cpu().numpy(),
        "pq.centers": idx.pq.centers.cpu().numpy(),
        "rerank_f32": None if idx.rerank_f32 is None else idx.rerank_f32.cpu().numpy(),
        "assignments": idx.assignments.cpu().numpy(), "n_points": idx.n_points,
        "spill_mode": idx.spill_mode, "lam": idx.lam}
    if idx.rerank_int8 is not None:
        fields["rerank_int8.q"] = idx.rerank_int8.q.cpu().numpy()
        fields["rerank_int8.scale"] = idx.rerank_int8.scale.cpu().numpy()
    rt = idx.router
    if rt is not None:
        fields.update({
            "router": {"type": "tree", "t_route": rt.t_route,
                       "n_partitions": rt.n_partitions},
            "router.super_centroids": rt.super_centroids.cpu().numpy(),
            "router.children": rt.children.cpu().numpy(),
            "router.child_centroids": rt.child_centroids.cpu().numpy()})
    return convert.index_from_numpy(fields, device=device)


def test_slice_on_card_matches_cpu(cuda):
    """Build + search on the card, through the CUDA kernels, against the
    same slice on the CPU (n=20k, d=32, c=64, m=8)."""
    ds = make_manifold(0, 20_000, 32, nq=200, device="cpu")
    X, Q = ds.X, ds.Q
    launches0 = (vq_assign.launches, soar_assign.launches, lloyd_sweep.launches,
                 pq_score_probes_select.launches)
    cpu = build_ivf_sharded(torch.Generator().manual_seed(0), X, 64,
                            pq_subspaces=8, device="cpu")
    # frozen seam: same codebook and PQ, assignment and encode on the card
    card = build_ivf_sharded(None, X, 64, codebook=cpu.centroids, pq=cpu.pq,
                             device=cuda)
    a0, a1 = cpu.assignments.numpy(), card.assignments.cpu().numpy()
    assert (a0 == a1).all(axis=1).mean() >= 0.999
    if (a0 == a1).all():
        assert torch.equal(card.starts.cpu(), cpu.starts)
        assert torch.equal(card.point_ids.cpu(), cpu.point_ids)
        assert float((card.codes.cpu() == cpu.codes).float().mean()) >= 0.999
    # search the same index on both devices
    kw = dict(top_t=8, final_k=10, rerank_budget=64, bq=64)
    ids0, s0 = search_jit_batched(pack_ivf(cpu), Q, **kw)
    ids1, s1 = search_jit_batched(pack_ivf(_to(cpu, cuda)), Q, **kw)
    same = (ids1.cpu() == ids0).numpy()
    assert same.mean() >= 0.995
    np.testing.assert_allclose(s1.cpu().numpy()[same], s0.numpy()[same], rtol=1e-5)
    # free builds on the card (Lloyd kernel included) against the CPU's:
    # two devices' float paths are two draws, so the mean recall over
    # seeds 0-3 on each side (tests/torch_recall.py)
    gt = true_neighbors(X, Q, k=10)

    def draw(device):
        def recall(seed):
            idx = cpu if (seed, device) == (0, "cpu") else build_ivf_sharded(
                torch.Generator().manual_seed(seed), X, 64, pq_subspaces=8, device=device)
            ids, _ = search_jit_batched(pack_ivf(idx), Q, **kw)
            return recall_at_k(ids.cpu(), gt, 10)
        return recall

    assert_recall_means_close(draw(cuda), draw("cpu"))
    assert all(b > a for a, b in zip(launches0, (
        vq_assign.launches, soar_assign.launches, lloyd_sweep.launches,
        pq_score_probes_select.launches)))


def test_assign_fused_on_card_matches_cpu(cuda):
    X, C = _normal(66, 3000, 48), _normal(67, 130, 48)
    for n_spills, lam in ((0, 0.0), (1, 0.0), (1, 1.0)):
        want = assign_fused(torch.from_numpy(X), torch.from_numpy(C), lam, n_spills)
        got = assign_fused(torch.from_numpy(X).to(cuda), torch.from_numpy(C).to(cuda),
                           lam, n_spills).cpu()
        assert float((got == want).all(dim=1).float().mean()) >= 0.999


def test_tree_filtered_slice_on_card_matches_cpu(cuda):
    """A tree-routed index built on the CPU, searched with a 1% filter and
    escalation on both devices (the tree_route kernel on the card)."""
    ds = make_manifold(0, 20_000, 32, nq=200, device="cpu")
    cpu = build_ivf_sharded(torch.Generator().manual_seed(0), ds.X, 64, pq_subspaces=8,
                            router="tree", router_kw={"t_route": 2}, device="cpu")
    bits = torch.zeros(20_000, dtype=torch.uint8)
    bits[torch.randperm(20_000, generator=torch.Generator().manual_seed(1))[:200]] = 1
    kw = dict(top_t=8, final_k=10, rerank_budget=64, bq=64, filter=bits, escalate=True)
    n0 = tree_route.launches
    ids0, s0 = search_jit_batched(pack_ivf(cpu), ds.Q, **kw)
    ids1, s1 = search_jit_batched(pack_ivf(_to(cpu, cuda)), ds.Q, **kw)
    assert tree_route.launches == n0 + 2 * 4     # two passes over four tiles
    same = (ids1.cpu() == ids0).numpy()
    assert same.mean() >= 0.995
    np.testing.assert_allclose(s1.cpu().numpy()[same], s0.numpy()[same], rtol=1e-5)
    got = ids1.cpu()
    assert bool((bits[got[got >= 0].long()] > 0).all())
    # a tree router trained on the card: the Lloyd kernel at c rows x S supers
    card = build_ivf_sharded(torch.Generator().manual_seed(0), ds.X, 64, pq_subspaces=8,
                             codebook=cpu.centroids, pq=cpu.pq, router="tree",
                             router_kw={"t_route": 2}, device=cuda)
    assert card.router.n_super == cpu.router.n_super == 8
    ch = card.router.children.cpu()
    assert sorted(ch[ch >= 0].tolist()) == list(range(64))
    gt = true_neighbors(ds.X, ds.Q, k=10)
    kw = dict(top_t=8, final_k=10, rerank_budget=64, bq=64)
    r_card = recall_at_k(search_jit_batched(pack_ivf(card), ds.Q, **kw)[0].cpu(), gt, 10)
    r_cpu = recall_at_k(search_jit_batched(pack_ivf(cpu), ds.Q, **kw)[0], gt, 10)
    assert abs(r_card - r_cpu) <= 0.05, (r_card, r_cpu)


@pytest.mark.parametrize("selectivity", [0.01, 0.001])
def test_budget_filtered_search_on_card_matches_cpu(cuda, selectivity):
    """`escalate="budget"` on a glove-shaped slice (d 100, m 50, c 120):
    the card's answers equal the CPU's and the plain reference's
    (tests/filtered_ref.py), two card runs give the same bits, a thin
    query searched alone (padded to tile_rows) gets the bits it gets in
    its full tile, and the counters add up under the settled path:
    `scored` is the eligible slots under the partitions each query
    probed, at most `gathered`, their slots, in every row's first pass at
    top_t and each thin row's one pass at its reference step."""
    ds = make_manifold(0, 60_000, 100, nq=300, device="cpu")
    card = build_ivf_sharded(torch.Generator().manual_seed(0), ds.X.to(cuda), 120,
                             pq_subspaces=50, device=cuda)
    cpu = _to(card, "cpu")
    bits = (torch.rand(60_000, generator=torch.Generator().manual_seed(1))
            < selectivity).to(torch.uint8)
    kw = dict(top_t=8, final_k=10, rerank_budget=128, bq=128, tile_rows=128, filter=bits,
              escalate="budget")
    packed_cpu, packed_card = pack_ivf(cpu), pack_ivf(card)
    ids0, s0 = search_jit_batched(packed_cpu, ds.Q, **kw)
    spans.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        ids1, s1 = search_jit_batched(packed_card, ds.Q.to(cuda), **kw)
    recs = spans.spans()
    spans.reset()
    ids2, s2 = search_jit_batched(packed_card, ds.Q.to(cuda), **kw)
    assert torch.equal(ids1, ids2) and torch.equal(s1, s2)
    same = (ids1.cpu() == ids0).numpy()
    assert same.mean() >= 0.995
    np.testing.assert_allclose(s1.cpu().numpy()[same], s0.numpy()[same], rtol=1e-5)
    got = ids1.cpu()
    assert bool((bits[got[got >= 0].long()] > 0).all())
    ix = fr.Index(packed_cpu.centroids, packed_cpu.part_ids, packed_cpu.part_codes,
                  packed_cpu.pq.centers, packed_cpu.rerank)
    ref = fr.search(ix, ds.Q, bits, top_t=8, k=10, budget=128)
    assert (got.long() == ref.ids).float().mean() >= 0.995
    total = {k: sum(s.counts.get(k, 0) for s in recs) for k in ("probed", "gathered", "scored")}
    part_ids = packed_cpu.part_ids
    elig = ((part_ids >= 0) & (bits[part_ids.clamp(min=0).long()] > 0)).sum(1)
    want = dict(probed=0, gathered=0, scored=0)
    for st in range(int(ref.steps.max()) + 1):
        for t in {8, min(8 << st, 120)}:
            rows = ref.steps == st
            parts = torch.topk(ds.Q[rows] @ packed_cpu.centroids.T, t).indices
            want["probed"] += parts.numel()
            want["gathered"] += int(packed_cpu.extent[parts].sum())
            want["scored"] += int(elig[parts].sum())
    assert total == want and total["scored"] < total["gathered"]
    esc = [s for s in recs if s.name == "search.escalate"]
    assert sum(s.counts["settled"] for s in esc) == int((ref.steps > 0).sum())
    for st in sorted(set(ref.steps.tolist()) - {0}):       # a thin query of each step
        i = int(torch.nonzero(ref.steps == st)[0, 0])
        a, sa = search_jit_batched(packed_card, ds.Q[i:i + 1].to(cuda), **kw)
        assert torch.equal(a, ids1[i:i + 1]) and torch.equal(sa, s1[i:i + 1])


# ------------------------------------------------- the rest of the build
def _columns_distinct(a):
    srt = torch.sort(a, dim=1).values
    return bool((srt[:, 1:] != srt[:, :-1]).all())


@pytest.mark.parametrize("n_spills", [2, 3])
def test_assign_fused_multi_spill_on_card_matches_cpu(cuda, n_spills):
    """Columns 0-1 from the vq and soar kernels, the rest in plain torch
    on the card, against the same call on the CPU (>= 99.9% per column);
    20,000 rows span three of the plain columns' 8,192-row chunks."""
    X, C = _normal(80, 20_000, 100), _normal(81, 300, 100)
    n0 = (vq_assign.launches, soar_assign.launches)
    want = assign_fused(torch.from_numpy(X), torch.from_numpy(C), 1.0, n_spills)
    got = assign_fused(torch.from_numpy(X).to(cuda), torch.from_numpy(C).to(cuda),
                       1.0, n_spills).cpu()
    assert (vq_assign.launches, soar_assign.launches) == (n0[0] + 1, n0[1] + 1)
    assert got.shape == want.shape == (20_000, 1 + n_spills)
    for j in range(1 + n_spills):
        assert float((got[:, j] == want[:, j]).float().mean()) >= 0.999
    assert _columns_distinct(got)


def test_anisotropic_assign_and_int8_on_card_match_cpu(cuda):
    X, C = _normal(82, 30_000, 100), _normal(83, 500, 100)
    eta = eta_from_threshold(0.2, 100)
    want = anisotropic_assign(torch.from_numpy(X), torch.from_numpy(C), eta)
    got = anisotropic_assign(torch.from_numpy(X).to(cuda), torch.from_numpy(C).to(cuda), eta)
    assert float((got.cpu() == want).float().mean()) >= 0.999
    wq = int8_quantize(torch.from_numpy(X))
    gq = int8_quantize(torch.from_numpy(X).to(cuda))
    assert torch.equal(gq.q.cpu(), wq.q) and torch.equal(gq.scale.cpu(), wq.scale)


def test_probe_scorer_reads_to_the_extent_past_tombstones(cuda):
    """Extents past the live count, with -1 ids inside them: the kernel
    scores every slot below the extent as the plain version does, and a
    search over such a table gives the CPU's ids and never a removed id."""
    ds = make_manifold(0, 20_000, 32, nq=200, device="cpu")
    idx = build_ivf_sharded(torch.Generator().manual_seed(0), ds.X, 64, pq_subspaces=8,
                            device="cpu")
    p = pack_ivf(idx)
    g = torch.Generator().manual_seed(5)
    dead = (torch.rand(p.part_ids.shape, generator=g) < 0.2) & (p.part_ids >= 0)
    ids = torch.where(dead, -1, p.part_ids)
    live = (ids >= 0).sum(1).to(torch.int32)
    assert bool((p.extent > live).all())
    tomb = p._replace(part_ids=ids, sizes=live)
    on_card = type(tomb)(*(t.to(cuda) if isinstance(t, torch.Tensor) else t for t in tomb))
    on_card = on_card._replace(pq=type(tomb.pq)(tomb.pq.centers.to(cuda)))
    luts = torch.from_numpy(_normal(84, 128, 8, 16)).to(cuda)
    parts = torch.randint(0, 64, (128, 12), generator=g).to(cuda)
    psc = torch.from_numpy(_normal(85, 128, 12)).to(cuda)
    args = (luts, on_card.part_codes, on_card.extent, parts, psc)
    got, want = pq_score_probes(*args), ref.pq_score_probes_ref(*args)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-5)
    kw = dict(top_t=8, final_k=10, rerank_budget=64, bq=64)
    ids0, _ = search_jit_batched(tomb, ds.Q, **kw)
    ids1, _ = search_jit_batched(on_card, ds.Q.to(cuda), **kw)
    assert float((ids1.cpu() == ids0).float().mean()) >= 0.995
    assert bool((ids1 >= 0).all())                  # every window keeps live points
    removed = set(p.part_ids[dead].tolist()) - set(ids[ids >= 0].tolist())
    assert not removed & set(ids1.cpu().flatten().tolist())


@pytest.mark.parametrize("T,n_spills,rerank", [(0.0, 2, "int8"), (0.2, 1, "f32")])
def test_build_ivf_on_card(cuda, T, n_spills, rerank):
    """The monolithic build on the card, small: the spill kernels ran, the
    columns are distinct, and recall@10 is within 0.02 of the CPU build's."""
    ds = make_manifold(1, 20_000, 32, nq=200, device="cpu")
    kw = dict(spill_mode="soar", n_spills=n_spills, anisotropic_T=T, rerank=rerank,
              pq_subspaces=8, train_iters=9)
    n0 = (soar_assign.launches, lloyd_sweep.launches)
    card = build_ivf(torch.Generator().manual_seed(0), ds.X, 64, device=cuda, **kw)
    assert soar_assign.launches > n0[0] and lloyd_sweep.launches > n0[1]
    assert card.assignments.shape == (20_000, 1 + n_spills)
    assert _columns_distinct(card.assignments)
    assert (card.rerank_int8 is not None) == (rerank == "int8")
    cpu = build_ivf(torch.Generator().manual_seed(0), ds.X, 64, device="cpu", **kw)
    gt = true_neighbors(ds.X, ds.Q, k=10)
    search = dict(top_t=8, final_k=10, rerank_budget=64, bq=64)
    r_card = recall_at_k(search_jit_batched(pack_ivf(card), ds.Q, **search)[0].cpu(), gt, 10)
    r_cpu = recall_at_k(search_jit_batched(pack_ivf(cpu), ds.Q, **search)[0], gt, 10)
    assert abs(r_card - r_cpu) <= 0.02, (r_card, r_cpu)


@pytest.mark.parametrize("mode", [dict(init="parallel"), dict(batch_size=16_384),
                                  dict(spherical=True)])
def test_train_kmeans_modes_on_card(cuda, mode):
    """The flagged k-means modes on the card (the Lloyd kernel in every
    sweep): distortion within 5% of the same mode on the CPU."""
    X = make_manifold(2, 40_000, 100, nq=1, device="cpu").X
    n0 = lloyd_sweep.launches
    card = train_kmeans(torch.Generator().manual_seed(0), X.to(cuda), 200, iters=8, **mode)
    assert lloyd_sweep.launches > n0
    cpu = train_kmeans(torch.Generator().manual_seed(0), X, 200, iters=8, **mode)
    assert float(card.distortion) <= 1.05 * float(cpu.distortion)
    if mode.get("spherical"):
        torch.testing.assert_close(card.centroids.norm(dim=1).cpu(), torch.ones(200))


def test_d2_draw_on_card_equals_cpu_and_seeding_repeats(cuda):
    """k-means++ draws from an exact integer CDF: on the card they equal
    the CPU's draws from the same weights and uniforms, and a seeding of
    2,500 centroids from 32,768 rows (a 1,000,000-row shard's build)
    repeats bit for bit. A float cumsum on the card did neither: two
    builds of one shard could differ in their centroids."""
    g = torch.Generator().manual_seed(0)
    w = torch.rand((1, 32_768), generator=g) ** 4
    w[:, ::7] = 0.0
    u = torch.rand((2000, 1), generator=g)
    card = torch.stack([kmeans._d2_draw(w.to(cuda), ui.to(cuda)) for ui in u]).cpu()
    cpu = torch.stack([kmeans._d2_draw(w, ui) for ui in u])
    assert torch.equal(card, cpu)
    assert bool((w[0, card[:, 0]] > 0).all())
    X = make_manifold(3, 32_768, 100, nq=1, device=cuda).X
    first = kmeans.kmeans_pp_init(torch.Generator().manual_seed(1), X, 2500)
    for _ in range(2):
        assert torch.equal(kmeans.kmeans_pp_init(torch.Generator().manual_seed(1), X, 2500),
                           first)


def _int_pp_case(m, n, d, c, seed=0):
    """Small integer coordinates, so that every f32 dot and norm is exact
    in any order: the kernel and the plain loop then see the same
    distances, and must pick the same rows."""
    g = torch.Generator().manual_seed(seed)
    X = torch.randint(-8, 9, (m, n, d), generator=g).float()
    return X, torch.randint(0, n, (m,), generator=g), torch.rand((c - 1, m), generator=g)


@pytest.mark.parametrize("m,n,d,c", [(1, 32_768, 100, 2000), (1, 4096, 100, 4096),
                                     (50, 32_768, 2, 16)])
def test_kmeans_pp_kernel_picks_the_plain_loops_rows(cuda, monkeypatch, m, n, d, c):
    """The seeding kernel's centres equal the plain loop's bit for bit, in
    one launch, on the whole card (m 1), with every row picked (n = c),
    and for PQ's 50 small problems; and on every other path the kernel
    has at the shape: teams of one block, rows read from device memory,
    norms and distances kept in device memory."""
    X, first, u = _int_pp_case(m, n, d, c)
    want = ref.kmeans_pp_ref(X, first, u)
    args = (X.to(cuda), first.to(cuda), u.to(cuda))
    n0 = kmeans_pp.launches
    assert torch.equal(kmeans_pp(*args).cpu(), want)
    assert kmeans_pp.launches == n0 + 1
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    own = kmeans_pp_mod.plan(m, n, d, sms)
    one = kmeans_pp_mod.plan(m, n, d, min(m, sms))
    paths = [one, own._replace(xmode=kmeans_pp_mod.X_GLOBAL, smem=16 * own.stride4 + 8 * own.rows),
             own._replace(xmode=kmeans_pp_mod.X_GLOBAL, state_shared=0, smem=16 * own.stride4)]
    for p in paths:
        monkeypatch.setattr(kmeans_pp_mod, "plan", lambda *a, p=p: p)
        assert torch.equal(kmeans_pp(*args).cpu(), want), p


def test_kmeans_pp_kernel_repeats_and_seeds_as_well_as_the_plain_loop(cuda, monkeypatch):
    """On manifold data a seeding repeats bit for bit, its seeds are
    distinct rows of the data, it leaves the generator where the CPU's
    plain loop does, and over 5 seeds the distortion after 15 Lloyd
    sweeps is within 1% of the plain loop's (on the card: the same data,
    another order of the f32 sums)."""
    X = make_manifold(5, 40_000, 100, nq=1, device=cuda).X
    Xs = X[:32_768].contiguous()
    a = kmeans.kmeans_pp_init(torch.Generator().manual_seed(1), Xs, 1000)
    gen = torch.Generator().manual_seed(1)
    assert torch.equal(kmeans.kmeans_pp_init(gen, Xs, 1000), a)
    rows = {r.tobytes() for r in Xs.cpu().numpy()}
    seeds = [r.tobytes() for r in a.cpu().numpy()]
    assert set(seeds) <= rows and len(set(seeds)) == 1000
    gcpu = torch.Generator().manual_seed(1)
    kmeans.kmeans_pp_init(gcpu, Xs[:, :4].cpu(), 1000)
    assert torch.equal(gen.get_state(), gcpu.get_state())

    def distortion():
        return [float(train_kmeans(torch.Generator().manual_seed(s), X, 500,
                                   iters=15).distortion) for s in range(5)]
    fused = distortion()
    monkeypatch.setattr(kmeans, "kmeans_pp", ref.kmeans_pp_ref)
    loop = distortion()
    assert abs(np.mean(fused) / np.mean(loop) - 1.0) <= 0.01, (fused, loop)


def test_kmeans_pp_seed_spans_count_fused_picks(cuda):
    """On the card every k-means++ pick of a build's codebook and PQ
    seeding is made inside the kernel, one launch a seeding:
    `fused_picks` equals `picks` on "kmeans.seed" and "pq.seed"."""
    from repro_torch import spans
    from repro_torch.quant.pq import train_pq
    X = make_manifold(6, 40_000, 100, nq=1, device=cuda).X
    spans.reset()
    n0 = kmeans_pp.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        train_kmeans(torch.Generator().manual_seed(0), X, 200, iters=2)
        train_pq(torch.Generator().manual_seed(0), X, 50, iters=2)
    seeds = {s.name: s.counts for s in spans.spans() if s.name.endswith(".seed")}
    spans.reset()
    assert kmeans_pp.launches == n0 + 2
    assert seeds == {"kmeans.seed": {"picks": 199, "fused_picks": 199},
                     "pq.seed": {"picks": 15 * 50, "fused_picks": 15 * 50}}


# ------------------------------------------------------------ serving slice
@pytest.mark.parametrize("n", [1, 7, 1000])
def test_assign_fused_online_batches_match_plain(cuda, n):
    """`MutableIVF.add`'s batch sizes: primary and spill through the vq and
    soar kernels against their plain versions on the same card inputs."""
    X = torch.from_numpy(_normal(90 + n, n, 100)).to(cuda)
    C = torch.from_numpy(_normal(91, 2000, 100)).to(cuda)
    n0 = (vq_assign.launches, soar_assign.launches)
    got = assign_fused(X, C, 1.0, 1)
    assert (vq_assign.launches, soar_assign.launches) == (n0[0] + 1, n0[1] + 1)
    prim = ref.vq_assign_ref(X, C)[0]
    r = X - C[prim.long()]
    rhat = r / torch.linalg.vector_norm(r, dim=-1, keepdim=True).clamp(min=1e-12)
    sec = ref.soar_assign_ref(X, rhat, prim, C, 1.0)[0]
    want = torch.stack([prim, sec], 1)
    assert float((got == want).all(dim=1).float().mean()) >= 0.999


def test_assign_fused_rows_are_independent_of_the_batch(cuda):
    """Each row's assignment is the same bits alone, in a 1,000-row batch
    or inside a 65,536-row shard: what mutated ≡ rebuilt relies on."""
    X = torch.from_numpy(_normal(92, 65_536, 100)).to(cuda)
    C = torch.from_numpy(_normal(93, 2000, 100)).to(cuda)
    full = assign_fused(X, C, 1.0, 1)
    rows = torch.randperm(65_536, generator=torch.Generator().manual_seed(0))[:1000]
    rows = rows.to(cuda)
    assert torch.equal(assign_fused(X[rows].contiguous(), C, 1.0, 1), full[rows])
    for i in (0, 1, 4097, 65_535):
        assert torch.equal(assign_fused(X[i:i + 1].contiguous(), C, 1.0, 1), full[i:i + 1])


def test_pruned_tree_route_on_card(cuda):
    """A pruned router (-1 inside children rows, and a super with no child
    left) through the kernel: equal to tree_route_ref on the pruned tables,
    and to the unpruned route restricted to the live partitions."""
    S, cmax, d, tr = 24, 40, 100, 6
    g = torch.Generator().manual_seed(11)
    SC = torch.randn((S, d), generator=g)
    CC = torch.randn((S, cmax, d), generator=g)
    CH = torch.arange(S * cmax, dtype=torch.int32).reshape(S, cmax)
    CH[:, -5:] = -1                                  # padding, as training leaves
    CC[:, -5:] = 0.0
    c = S * cmax
    live = torch.rand(c, generator=g) < 0.6
    Q = torch.randn((256, d), generator=g)
    # the best super of query 0 keeps no child
    live[CH[torch.argmax(Q @ SC.T, 1)[0]].clamp(min=0).long()] = False
    full = TreeRouter(SC.to(cuda), CH.to(cuda), CC.to(cuda), tr, c)
    pruned = full.pruned(live.to(cuda))
    assert torch.equal(full.children.cpu(), CH)
    empty = (pruned.children < 0).all(dim=1)
    assert bool(empty.any()) and bool(((pruned.children < 0) & (CH.to(cuda) >= 0)).any())
    Qc = Q.to(cuda)
    n0 = tree_route.launches
    gs, gi = tree_route(Qc, pruned.super_centroids, pruned.child_centroids,
                        pruned.children, tr)
    assert tree_route.launches == n0 + 1
    ws, wi = ref.tree_route_ref(Qc, pruned.super_centroids, pruned.child_centroids,
                                pruned.children, tr)
    assert torch.equal(gi, wi)
    assert torch.equal(torch.isinf(gs), torch.isinf(ws))
    fin = torch.isfinite(ws)
    torch.testing.assert_close(gs[fin], ws[fin], rtol=1e-4, atol=1e-4)
    # the unpruned route with dead partitions' candidates at -inf
    us, ui = tree_route(Qc, SC.to(cuda), CC.to(cuda), CH.to(cuda), tr)
    dead = (ui >= 0) & ~live.to(cuda)[ui.clamp(min=0).long()]
    torch.testing.assert_close(gs, us.masked_fill(dead, float("-inf")), rtol=0, atol=0)
    for top_t in (8, 40):
        ps, pp = pruned.route(Qc, top_t)
        assert bool(live.to(cuda)[pp[torch.isfinite(ps)].long()].all())


def _card_mutable(cuda, seed=0):
    ds = make_manifold(seed, 20_000, 32, nq=200, device="cpu")
    return ds, MutableIVF.build(torch.Generator().manual_seed(seed), ds.X[:15_000], 64,
                                spill_mode="soar", pq_subspaces=8, router="tree",
                                device=cuda)


def test_delta_pack_equals_full_pack_on_card(cuda):
    """Add, hard and soft remove on the card, with every child of one super
    emptied: the delta-packed snapshot is a view of the index's tensors,
    and its sizes, extent and pruned router equal a full repack's; both
    search alike."""
    ds, mut = _card_mutable(cuda)
    mut.compact_threshold = 1.0          # no compaction: the delta path is under test
    n0 = (vq_assign.launches, soar_assign.launches)
    new = mut.add(ds.X[15_000:16_000].to(cuda))
    assert vq_assign.launches > n0[0] and soar_assign.launches > n0[1]
    mut.pack()                           # the add grew the rows: a full pack
    mut.add(ds.X[16_000:16_050].to(cuda))
    assert mut.remove(new[::4]) == 250
    assert mut.remove(torch.arange(0, 15_000, 7, device=cuda)) > 0
    ch = mut.router.children[0]
    slots = mut.part_ids[ch[ch >= 0].long()]
    assert mut.remove(torch.unique(slots[slots >= 0])) > 0
    assert mut.remove(torch.arange(15_000, 15_500, 3, device=cuda), hard=False) > 0
    assert mut._dirty_parts is not None and bool(mut._dirty_parts.any())
    delta = mut.pack()
    for a, b in ((delta.part_ids, mut.part_ids), (delta.part_codes, mut.part_codes),
                 (delta.rerank, mut.rerank)):
        assert a.data_ptr() == b.data_ptr()
    assert (delta.router.children[0] < 0).all() and delta.router is not mut.router
    kw = dict(top_t=8, final_k=10, rerank_budget=64, bq=64)
    filt, _ = mut.serving_filter()
    di, dv = search_jit_batched(delta, ds.Q.to(cuda), filter=filt, **kw)
    mut.invalidate_snapshots()
    full = mut.pack()
    assert full is not delta and full.router is not delta.router
    for a, b in ((delta.sizes, full.sizes), (delta.extent, full.extent),
                 (delta.router.children, full.router.children)):
        assert torch.equal(a, b)
    fi, fv = search_jit_batched(full, ds.Q.to(cuda), filter=filt, **kw)
    assert torch.equal(di, fi) and torch.equal(dv, fv)


def test_search_numpy_on_card_matches_cpu(cuda):
    """The host engine over a mutated index's CSR snapshot, on the card
    (tree route kernel) and on the CPU, with and without a PQ stage and a
    filter."""
    ds, mut = _card_mutable(cuda, seed=1)
    mut.add(ds.X[15_000:].to(cuda))
    mut.remove(torch.arange(0, 20_000, 5, device=cuda))
    card = mut.to_ivf_index()
    cpu = convert.index_from_numpy({
        "centroids": card.centroids.cpu().numpy(), "starts": card.starts.cpu().numpy(),
        "point_ids": card.point_ids.cpu().numpy(), "codes": card.codes.cpu().numpy(),
        "pq.centers": card.pq.centers.cpu().numpy(),
        "rerank_f32": card.rerank_f32.cpu().numpy(),
        "assignments": card.assignments.cpu().numpy(), "n_points": card.n_points,
        "spill_mode": card.spill_mode, "lam": card.lam}, device="cpu")
    rt = card.router
    cpu_rt = TreeRouter(rt.super_centroids.cpu(), rt.children.cpu(),
                        rt.child_centroids.cpu(), rt.t_route, rt.n_partitions)
    mask = (torch.rand(20_000, generator=torch.Generator().manual_seed(3)) < 0.05)
    n0 = tree_route.launches
    for kw in (dict(rerank_budget=64), dict(rerank_budget=0),
               dict(rerank_budget=64, filter_mask=mask.numpy())):
        gi, gs = search_numpy(card, ds.Q.to(cuda), top_t=8, final_k=10, **kw)
        wi, ws = search_numpy(cpu, ds.Q, top_t=8, final_k=10, router=cpu_rt, **kw)
        assert float((gi.cpu() == wi).float().mean()) >= 0.995
        assert torch.equal(gs.points_read.cpu(), ws.points_read)
    assert tree_route.launches > n0


def _same_mutable(a, b):
    """Two MutableIVFs equal bit for bit: state, counters, router tables."""
    for k in ("centroids", "part_ids", "part_codes", "sizes", "rerank",
              "assignments", "alive"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.device == y.device and torch.equal(x, y), k
    for k in ("n_total", "n_dead_slots", "n_soft_deleted", "wal_seq"):
        assert getattr(a, k) == getattr(b, k), k
    for k in ("super_centroids", "children", "child_centroids"):
        assert torch.equal(getattr(a.router, k), getattr(b.router, k)), k
    assert torch.equal(a.pq.centers, b.pq.centers)


def test_mutable_snapshot_roundtrips_on_card(cuda, tmp_path):
    """A mutated card index saved and read back onto the card is the same
    bits, searches alike, and reads onto the CPU as the same bits too."""
    ds, mut = _card_mutable(cuda, seed=2)
    mut.add(ds.X[15_000:16_000].to(cuda))
    mut.remove(torch.arange(0, 15_000, 9, device=cuda))
    mut.remove(torch.arange(1, 15_000, 11, device=cuda), hard=False)
    p = str(tmp_path / "snap")
    save_snapshot(p, mut)
    back, _ = load_snapshot(p, expect_kind="MutableIVF")
    assert back.device.type == "cuda"
    _same_mutable(back, mut)
    kw = dict(top_t=8, rerank_budget=64)
    Qn = ds.Q.numpy()
    a = AnnEngine(mut, **kw).search(Qn, k=10)
    b = AnnEngine(back, **kw).search(Qn, k=10)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    cpu, _ = load_snapshot(p, device="cpu")
    for k in ("part_ids", "part_codes", "rerank", "assignments", "alive"):
        assert torch.equal(getattr(cpu, k), getattr(mut, k).cpu()), k


def test_wal_replay_on_card_equals_live(cuda, tmp_path):
    """Snapshot, then a logged mutation script on the card; a second engine
    opened from the snapshot and the log replays it through the vq and
    SOAR kernels to the live state, bit for bit."""
    ds, mut = _card_mutable(cuda, seed=3)
    p = str(tmp_path / "eng")
    AnnEngine(mut, top_t=8, rerank_budget=64).save(p)
    live = AnnEngine.open(p, wal=True)
    m = live.index
    for r in range(3):
        m.remove(torch.arange(r, 15_000, 13, device=cuda))
        m.add(ds.X[15_000 + 500 * r:15_500 + 500 * r].to(cuda))
    m.remove(torch.arange(5, 15_000, 17, device=cuda), hard=False)
    m.harden_soft_deletes()
    m.compact()
    n0 = (vq_assign.launches, soar_assign.launches)
    again = AnnEngine.open(p)
    assert vq_assign.launches > n0[0] and soar_assign.launches > n0[1]
    _same_mutable(again.index, m)
    assert again.index.wal_seq == 3 * 2 + 3
    Qn = ds.Q.numpy()
    assert np.array_equal(again.search(Qn, k=10)[0], live.search(Qn, k=10)[0])
    for e in (live, again):
        e.index._wal.close()


def test_kmr_curve_on_card_matches_cpu(cuda):
    """The KMR curve and rank statistics of one spilled index on the card
    and on the CPU."""
    ds = make_manifold(4, 20_000, 32, nq=200, device="cpu")
    idx = build_ivf_sharded(torch.Generator().manual_seed(4), ds.X.to(cuda), 64,
                            spill_mode="soar", device=cuda)
    cpu = convert.index_from_numpy({
        "centroids": idx.centroids.cpu().numpy(), "starts": idx.starts.cpu().numpy(),
        "point_ids": idx.point_ids.cpu().numpy(), "codes": None, "pq.centers": None,
        "rerank_f32": idx.rerank_f32.cpu().numpy(),
        "assignments": idx.assignments.cpu().numpy(), "n_points": idx.n_points,
        "spill_mode": idx.spill_mode, "lam": idx.lam}, device="cpu")
    tid = true_neighbors(ds.X, ds.Q, k=20)
    got = kmr_curve(idx, ds.Q.to(cuda), tid.to(cuda), k=20)
    want = kmr_curve(cpu, ds.Q, tid, k=20)
    np.testing.assert_allclose(got.points_at_t, want.points_at_t, rtol=1e-6)
    np.testing.assert_allclose(got.recall_at_t, want.recall_at_t, rtol=0, atol=1e-6)
    gp, gs = rank_statistics(idx, ds.Q.to(cuda), tid.to(cuda))
    wp, ws = rank_statistics(cpu, ds.Q, tid)
    assert gp.device.type == "cuda"
    assert float((gp.cpu() == wp).float().mean()) >= 0.999
    assert float((gs.cpu() == ws).float().mean()) >= 0.999


def test_coalesced_equals_solo_on_card(cuda):
    """A query's ids and scores inside a batch equal its solo bits on the
    card, at every bucket from 8 to 128 and both routers: the engine pads
    to the bucket and runs every tile at bq rows (cuBLAS picks the rerank
    and flat-route products' algorithm by shape: 8 rows and 16 give other
    bits). Through the front-end too, with concurrent clients."""
    import threading
    ds, mut = _card_mutable(cuda, seed=5)
    flat = MutableIVF.build(torch.Generator().manual_seed(5), ds.X[:15_000], 64,
                            spill_mode="soar", pq_subspaces=8, device=cuda)
    Qn = ds.Q.numpy()
    for index in (mut, flat):
        eng = AnnEngine(index, top_t=8, rerank_budget=64)
        solo = [eng.search_request(Qn[i:i + 1], SearchParams(k=10)) for i in range(64)]
        for nq in (2, 9, 17, 33, 64, 100, 128, 200):
            r = eng.search_request(Qn[:nq], SearchParams(k=10))
            for i in range(min(nq, 64)):
                assert np.array_equal(r.ids[i], solo[i].ids[0]), (nq, i)
                assert np.array_equal(r.scores[i], solo[i].scores[0]), (nq, i)
    with ServingFrontend(eng, policy="local", default_deadline_ms=200.0) as fe:
        got = {}

        def client(i):
            got[i] = fe.submit(Qn[i:i + 1], SearchParams(k=10)).result(timeout=60)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert fe.stats["coalesced"] > 0
    for i in range(32):
        assert np.array_equal(got[i].ids, solo[i].ids)
        assert np.array_equal(got[i].scores, solo[i].scores)


def test_tenant_bitmap_on_card_refills_once_an_epoch(cuda):
    """TenantFilterBank.get returns a CUDA uint8 tensor (tenant ∧ alive at
    the capacity width), rebuilt once after each mutation and not again
    within the epoch; tenant search equals the same subset as filter_ids."""
    ds, mut = _card_mutable(cuda, seed=6)
    eng = AnnEngine(mut, top_t=8, rerank_budget=64)
    bank = TenantFilterBank(mut)
    keep = np.arange(0, 15_000, 4)
    bank.register("t", ids=keep)
    bm = bank.get("t")
    assert bm.device.type == "cuda" and bm.dtype == torch.uint8
    assert bm.shape[0] == mut.alive.shape[0] and int(bm.sum()) == keep.size
    assert bank.get("t") is bm and bank.fills == 1
    eng.remove(keep[:10])
    assert int(bank.get("t").sum()) == keep.size - 10 and bank.fills == 2
    bank.get("t")
    assert bank.fills == 2
    Qn = ds.Q.numpy()
    a = eng.search_request(Qn, SearchParams(k=10), _filter_dev=bank.get("t"))
    b = eng.search_request(Qn, SearchParams(k=10, filter_ids=keep[10:]))
    assert np.array_equal(a.ids, b.ids) and np.array_equal(a.scores, b.scores)


def test_replicated_search_on_card_equals_local(cuda):
    """make_replicated_search over [cuda:0, cuda:0], and the engine's
    replica branch over them: the local path's bits."""
    ds, mut = _card_mutable(cuda, seed=7)
    eng = AnnEngine(mut, top_t=8, rerank_budget=64)
    Qn = ds.Q.numpy()[:77]
    Qp, nq, bq = pad_queries(Qn, eng.bq, multiple=2)
    fn = make_replicated_search([cuda, cuda], top_t=8, final_k=10, rerank_budget=64,
                                multiplicity=2, bq=bq, tile_rows=eng.bq)
    ids, sc = fn(mut.pack(), Qp)
    want = eng.search_request(Qn, SearchParams(k=10))
    assert ids.device.type == "cuda"
    assert np.array_equal(ids[:nq].cpu().numpy(), want.ids)
    assert np.array_equal(sc[:nq].cpu().numpy(), want.scores)
    thin = np.arange(0, mut.n_total, 500)
    for p in (SearchParams(k=10), SearchParams(k=10, escalate="budget", filter_ids=thin)):
        want = eng.search_request(Qn, p)
        got = eng.search_request(Qn, p, _devices=[cuda, cuda])
        assert np.array_equal(got.ids, want.ids) and np.array_equal(got.scores, want.scores)


def test_knn_memory_on_card_matches_cpu_twin(cuda, tmp_path):
    """A KNNMemory built on the card and its CPU twin (the same snapshot
    read onto the CPU) retrieve the same ids on >= 0.999 of slots on both
    engines, after per-row-labelled adds and evictions; attend agrees on
    the rows whose ids agree; the vq and SOAR kernels ran the adds."""
    ds = make_manifold(8, 20_000, 32, nq=64, device="cpu")
    V = torch.randn(20_000, 32, generator=torch.Generator().manual_seed(8))
    mem = KNNMemory.build(ds.X[:19_000], V[:19_000], n_partitions=64, engine="jit",
                          segment=np.arange(19_000) % 4, device=cuda)
    assert mem.values.device.type == "cuda" and mem.segments.device.type == "cuda"
    n0 = (vq_assign.launches, soar_assign.launches)
    mem.add(ds.X[19_000:], V[19_000:], segment=np.arange(1000) % 4)
    assert vq_assign.launches > n0[0] and soar_assign.launches > n0[1]
    mem.remove(np.arange(0, 19_000, 9))
    mem.remove(np.arange(1, 19_000, 13), hard=False)
    p = str(tmp_path / "mem")
    mem.save(p)
    twin = KNNMemory.open(p, device="cpu")
    q = ds.Q.numpy()
    for engine in ("jit", "numpy"):
        mem.engine = twin.engine = engine
        for kw in (dict(), dict(segment=2), dict(recency=3000), dict(segment=1, recency=5000)):
            gi, _, _ = mem.retrieve(q, k=16, **kw)
            wi, _, _ = twin.retrieve(q, k=16, **kw)
            assert float((gi == wi).mean()) >= 0.999, (engine, kw)
        go, gids = mem.attend(q, k=16, segment=3)
        wo, wids = twin.attend(q, k=16, segment=3)
        rows = (gids == wids).all(1)
        np.testing.assert_allclose(go[rows], wo[rows], rtol=1e-4, atol=1e-5)


def _card_shards(seed, n_shards, n_local, d, c, m, **kw):
    """Per-shard indexes built on the CPU (tree routers of ragged super
    counts when `router_kw` lists them) and the queries."""
    ds = make_manifold(seed, n_shards * n_local, d, nq=70, device="cpu")
    supers = kw.pop("supers", None)
    idxs = [build_ivf_sharded(dist_mod.shard_generator(seed, s),
                              ds.X[s * n_local:(s + 1) * n_local], c, pq_subspaces=m,
                              train_iters=4, device="cpu",
                              **(dict(router="tree", router_kw=dict(n_super=supers[s]))
                                 if supers else {}), **kw)
            for s in range(n_shards)]
    return idxs, ds.Q


def test_sharded_searches_on_card_match_cpu(cuda):
    """Both makers, flat and tree-routed, filtered and with a shard down, on
    stacks moved to the card against the same calls on the CPU; the probe
    scorer and the tree route ran."""
    idxs, Q = _card_shards(3, 4, 2_000, 32, 16, 8, supers=[3, 4, 5, 4])
    iv, ivq = dist_mod.sharded_from_indexes(idxs), dist_mod.sharded_from_indexes_pq(idxs)
    srt = dist_mod.stack_tree_routers([i.router for i in idxs])
    filt = dist_mod.shard_filters(np.random.default_rng(0).random(8_000) < 0.3,
                                  [2_000] * 4)
    down = np.array([1, 1, 0, 1], np.uint8)
    cases = [
        (dist_mod.make_distributed_search(top_t=6), iv, ()),
        (dist_mod.make_distributed_search(top_t=6, with_router=True), iv, (srt,)),
        (dist_mod.make_distributed_search_pq(top_t=6, rerank_k=64, q_chunk=70,
                                             with_filter=True, with_health=True),
         ivq, (filt, down)),
        (dist_mod.make_distributed_search_pq(top_t=6, rerank_k=64, q_chunk=70,
                                             with_router=True, t_route=5), ivq, (srt,)),
    ]
    for i, (fn, ivf, extra) in enumerate(cases):
        n0 = (pq_score_probes_select.launches, tree_route.launches)
        gi, gs = fn(ivf.to(cuda), Q.to(cuda), *(e.to(cuda) if isinstance(e, torch.Tensor)
                                               or hasattr(e, "_fields") else e
                                               for e in extra))
        torch.cuda.synchronize()
        assert gi.device.type == "cuda"
        if ivf is ivq:
            assert pq_score_probes_select.launches > n0[0], i
        if extra and extra[0] is srt:
            assert tree_route.launches > n0[1], i
        wi, ws = fn(ivf, Q, *extra)
        agree = (gi.cpu() == wi).float().mean().item()
        assert agree >= 0.999, (i, agree)
        same = (gi.cpu() == wi) & torch.isfinite(ws)
        torch.testing.assert_close(gs.cpu()[same], ws[same], rtol=1e-5, atol=1e-5)


def test_sharded_pq_search_on_card_takes_unaligned_shard_blocks(cuda):
    """At m = 25, c = 9 a shard's (c, pmax, m) block is c·pmax·m bytes, not
    a multiple of 16 here: a plain stack's shard 1 starts off 16 bytes and
    the probe scorer refuses it; the port's stack keeps every block on 16
    bytes, so the sharded search runs and agrees with the CPU."""
    idxs, Q = _card_shards(5, 3, 1_500, 50, 9, 25)
    ivq = dist_mod.sharded_from_indexes_pq(idxs)
    _, c, pmax, m = ivq.part_codes.shape
    assert (c * pmax * m) % 16, "the case must not align by chance"
    on_card = ivq.to(cuda)
    assert all(on_card.part_codes[s].data_ptr() % 16 == 0 for s in range(3))
    plain = on_card.part_codes.contiguous()
    assert plain[1].data_ptr() % 16
    luts = torch.zeros((2, m, 16), device=cuda)
    parts = torch.zeros((2, 1), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        pq_score_probes(luts, plain[1], on_card.extent[1], parts,
                        torch.zeros((2, 1), device=cuda))
    fn = dist_mod.make_distributed_search_pq(top_t=4, rerank_k=32, q_chunk=70)
    n0 = pq_score_probes_select.launches
    gi, _ = fn(on_card, Q.to(cuda))
    torch.cuda.synchronize()
    assert pq_score_probes_select.launches > n0
    wi, _ = fn(ivq, Q)
    assert (gi.cpu() == wi).float().mean().item() >= 0.999


def test_stacked_tree_tables_with_padded_supers_route_as_plain(cuda):
    """Shards with 2 to 6 supers stacked to S = 6: the padded supers are
    zero rows (score 0, above the real supers' negative scores) whose
    children are all -1. Each shard's tables route on the card as the
    plain version does, at t_route = S too (every padded super chosen),
    and the router's starved slots are partition 0 at -inf."""
    idxs, Q = _card_shards(6, 4, 1_000, 16, 12, 4, supers=[2, 6, 3, 4])
    srt = dist_mod.stack_tree_routers([i.router for i in idxs]).to(cuda)
    Qc = Q.to(cuda)
    S = srt.super_centroids.shape[1]
    for s in range(4):
        tabs = (srt.super_centroids[s], srt.child_centroids[s], srt.children[s])
        for tr in (1, 3, S):
            gs, gi = tree_route(Qc, *tabs, tr)
            ws, wi = ref.tree_route_ref(Qc, *tabs, tr)
            assert torch.equal(gi, wi), (s, tr)
            fin = torch.isfinite(ws)
            assert torch.equal(fin, torch.isfinite(gs))
            torch.testing.assert_close(gs[fin], ws[fin], rtol=1e-5, atol=1e-5)
        local = (srt.super_centroids[s], srt.children[s], srt.child_centroids[s])
        for tr in (1, S):
            v, parts = dist_mod._local_router(idxs[s].centroids.to(cuda), local,
                                              tr).route(Qc, 12)
            wv, wp = dist_mod._local_router(idxs[s].centroids,
                                            tuple(t.cpu() for t in local), tr).route(Q, 12)
            assert torch.equal(parts.cpu(), wp), (s, tr)
            starved = torch.isneginf(v)
            assert torch.equal(starved.cpu(), torch.isneginf(wv))
            assert bool((parts[starved] == 0).all())


def test_sharded_search_under_a_gloo_group_on_card(cuda, tmp_path):
    """One gloo rank holding every shard on the card: the group form (gloo's
    all_gather of CUDA tensors) gives the in-process bits."""
    import torch.distributed as dist
    idxs, Q = _card_shards(4, 2, 1_000, 16, 8, 4)
    ivq = dist_mod.sharded_from_indexes_pq(idxs).to(cuda)
    Qc = Q.to(cuda)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        g = dist.group.WORLD
        got = dist_mod.make_distributed_search_pq(top_t=4, rerank_k=32, q_chunk=70,
                                                  group=g)(dist_mod.local_shards(ivq, g), Qc)
    finally:
        dist.destroy_process_group()
    want = dist_mod.make_distributed_search_pq(top_t=4, rerank_k=32, q_chunk=70)(ivq, Qc)
    assert got[0].device.type == "cuda"
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ------------------------------------------------- static analysis on the card

def test_analysis_cli_clean_on_card(cuda):
    """Lints and all 11 contracts at their tiny sizes, traced on the card
    over the kernels."""
    from repro_torch.analysis import check
    assert check.main(["--device", "cuda", "-q"]) == 0


@pytest.mark.parametrize("cls", ["host-sync", "o-n-intermediate", "f64-leak"])
def test_analysis_cli_injection_on_card(cuda, cls):
    from repro_torch.analysis import check
    assert check.main(["--only", "lint", "--inject", cls, "--device", "cuda", "-q"]) != 0


def test_host_sync_rule_sees_device_to_host_copies(cuda):
    """On the card a copy to the host is a sync; the same copy on the CPU
    is not."""
    from repro_torch.analysis import contracts
    x = torch.ones(8, device=cuda)
    for fn in (lambda t: t.cpu(), lambda t: t.to("cpu"), lambda t: (t * 2).cpu() + 1):
        rec = contracts.record_ops(contracts.TraceSpec(fn=fn, args=(x,)))
        assert rec.syncs == ["aten._to_copy.default:cuda->cpu"], rec.syncs
    rec = contracts.record_ops(contracts.TraceSpec(fn=lambda t: t.cpu(), args=(x.cpu(),)))
    assert rec.syncs == []


def test_lloyd_keeps_n_vectors_on_card(cuda):
    """The stated departure from JAX's lloyd_sweep rule: on the card the
    sweep keeps (n,) idx and mind between its two launches, so JAX's
    no_dims_1d flags the trace; the port's no_products rule holds."""
    from repro_torch.analysis import contracts
    c = contracts.REGISTRY["lloyd_sweep"]
    spec = c.build(cuda)
    before = lloyd_sweep.launches
    rec = contracts.record_ops(spec)
    assert lloyd_sweep.launches == before + 1
    n = spec.dims["n"]
    ones = {(o.shape, o.dtype) for o in rec.outputs if len(o.shape) == 1 and o.shape[0] >= n}
    assert {((n,), "int32"), ((n,), "float32")} <= ones
    jax_rule = contracts.JaxprContract("lloyd_sweep", c.build, no_dims_1d=frozenset({"n"}),
                                       no_products=c.no_products)
    assert contracts.evaluate(jax_rule, spec, rec) != []
    assert contracts.evaluate(c, spec, rec) == []


@pytest.mark.parametrize("name", ["search_jit", "search_jit_batched",
                                  "search_jit_batched_filtered", "distributed_search_pq",
                                  "replicated_search"])
def test_search_contracts_sync_free_on_card(cuda, name):
    """A search tile waits on the host nowhere: its contract holds, and
    torch's own sync check raises nothing, with the kernels launched."""
    from repro_torch.analysis import contracts
    c = contracts.REGISTRY[name]
    spec = c.build(cuda)
    spec.fn(*spec.args)                                    # warm
    before = pq_score_probes_select.launches
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rec = contracts.record_ops(spec)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    assert pq_score_probes_select.launches > before
    assert contracts.evaluate(c, spec, rec) == []


# ------------------------------------------------------- the LM serving path

LM_ARCHS = ("granite-3-2b", "nemotron-4-15b", "minitron-8b", "mistral-large-123b",
            "paligemma-3b", "qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b", "xlstm-350m",
            "hubert-xlarge", "jamba-v0.1-52b")
LM_CAUSAL = tuple(a for a in LM_ARCHS if a != "hubert-xlarge")


def _lm_twins(cuda, arch, **replace):
    """(cfg, the same f32 parameters on the CPU and on the card) at the
    smoke config."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TT
    cfg = get_config(arch).smoke_config().replace(**replace)
    cpu = TT.Transformer(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    card = TT.Transformer(cfg, {k: v for k, v in cpu.param_tree().items()}, device=cuda)
    return cfg, cpu, card


def _lm_inputs(cfg, B, S, seed, device):
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "audio":
        out["frames"] = torch.tensor(rng.standard_normal((B, S, cfg.d_model)),
                                     dtype=torch.float32, device=device)
        return out
    out["tokens"] = torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                 dtype=torch.int32, device=device)
    if cfg.frontend == "vision":
        out["patches"] = torch.tensor(rng.standard_normal((B, cfg.n_prefix_embeds, cfg.d_model)),
                                      dtype=torch.float32, device=device)
    return out


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_forward_on_card_matches_cpu(cuda, arch):
    """The port on the card against the port on the CPU, same f32
    parameters: forward logits within 1e-4 relative and 1e-4 of the
    largest |logit| (xlstm's mLSTM gates carry f32 errors of ~1e-5 of
    it, on either device)."""
    from repro_torch.models import transformer as TT
    cfg, cpu, card = _lm_twins(cuda, arch, compute_dtype="float32")
    with torch.no_grad():
        want = TT.logits_from_hidden(cpu.param_tree(), cpu(_lm_inputs(cfg, 2, 32, 1, "cpu"))[0], cfg)
        got = TT.logits_from_hidden(card.param_tree(), card(_lm_inputs(cfg, 2, 32, 1, cuda))[0], cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4,
                               atol=1e-4 * max(1.0, float(want.abs().max())))


@pytest.mark.parametrize("arch", LM_CAUSAL)
def test_lm_prefill_decode_consistency_on_card(cuda, arch):
    """decode_step after prefill reproduces the full forward's last logits
    on the card (f32, no MoE drops)."""
    from repro_torch.models import transformer as TT
    cfg, _, card = _lm_twins(cuda, arch, compute_dtype="float32", capacity_factor=8.0)
    S = 16
    batch = _lm_inputs(cfg, 2, S, 2, cuda)
    prefix = cfg.n_prefix_embeds if cfg.frontend == "vision" else 0
    with torch.no_grad():
        x, _ = card(batch)
        full = TT.logits_from_hidden(card.param_tree(), x[:, -1:], cfg)
        _, caches = card.prefill(dict(batch, tokens=batch["tokens"][:, :S - 1]), S + prefix)
        dec, _ = card.decode_step(batch["tokens"][:, S - 1:], caches, S - 1 + prefix)
    torch.testing.assert_close(dec, full, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", LM_CAUSAL)
def test_lm_generate_repeats_bitwise_on_card(cuda, arch):
    """bf16 greedy decoding gives the same ids twice, below the padded
    vocab, with no CUDA atomics in the MoE combine."""
    from repro_torch.serve.engine import ServeEngine
    cfg, _, card = _lm_twins(cuda, arch)
    eng = ServeEngine(cfg, card, max_seq=48, device=cuda)
    inputs = _lm_inputs(cfg, 3, 24, 3, cuda)
    inputs.pop("frames", None)
    a, b = eng.generate(inputs, 8), eng.generate(inputs, 8)
    assert a.device.type == cuda.type and torch.equal(a, b)
    assert int(a.max()) < cfg.vocab_padded and int(a.min()) >= 0


def test_moe_combine_repeats_bitwise_on_card(cuda):
    """The MoE layer at bf16 over 8,192 tokens (128 experts, top 8, the
    qwen3-moe widths) twice: the same bits, and drops at capacity 1.25."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe, params as prm
    cfg = get_config("qwen3-moe-30b-a3b")
    p = prm.init(torch.Generator().manual_seed(0), moe.moe_def(cfg), device=cuda)
    x = torch.randn((8, 1024, cfg.d_model), generator=torch.Generator().manual_seed(1)
                    ).to(cuda, torch.bfloat16)
    a, b = moe.moe_mlp(p, x, cfg), moe.moe_mlp(p, x, cfg)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert bool(torch.isfinite(a).all())


def test_lm_entry_points_turn_reduced_precision_off(cuda):
    from repro_torch.utils import resolve_device
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    resolve_device(None)
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is False


# --------------------------------------------------------- LM training on the card

def _train_twins(cuda, arch):
    """(cfg f32, the same parameters on the CPU and on the card, a batch of
    4 × 16 from the port's pipeline)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import for_model
    from repro_torch.models import params as prm, transformer as TT
    cfg = get_config(arch).smoke_config().replace(compute_dtype="float32")
    cpu = TT.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    card = prm.tree_map(lambda a: a.to(cuda, copy=True), cpu)
    return cfg, cpu, card, for_model(cfg, seq_len=16, global_batch=4).batch_at(0)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_step_on_card_matches_cpu(cuda, arch):
    """One train step (f32) on the card against the same step on the CPU:
    loss and grad_norm within 1e-5 relative, lr equal, every m leaf (0.1 ×
    the clipped gradient) within 1e-4 of its largest |value|, every
    parameter within rtol 1e-5 and atol 1e-4, the step's lr: Adam's first
    update is lr·g/(|g| + ε), so where |g| is near ε a last-bit difference
    in g moves the element by up to the step (xlstm's gates: 3.4e-5)."""
    from repro_torch.models import params as prm
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import make_train_step
    cfg, cpu, card, batch = _train_twins(cuda, arch)
    step = make_train_step(cfg, opt.warmup_cosine(1e-3, 10, 100))
    pc, sc, mc = step(cpu, opt.init(cpu), batch)
    pg, sg, mg = step(card, opt.init(card), {k: v.to(cuda) for k, v in batch.items()})
    assert sg.step.device.type == "cuda"
    for key in ("loss", "grad_norm"):
        assert abs(float(mg[key]) - float(mc[key])) <= 1e-5 * abs(float(mc[key])), key
    assert float(mg["lr"]) == float(mc["lr"])
    want = dict(prm.leaf_paths(sc.m))
    for path, t in prm.leaf_paths(sg.m):
        torch.testing.assert_close(t.cpu(), want[path], rtol=0,
                                   atol=1e-4 * float(want[path].abs().max()), msg=path)
    want = dict(prm.leaf_paths(pc))
    for path, t in prm.leaf_paths(pg):
        torch.testing.assert_close(t.cpu(), want[path], rtol=1e-5, atol=1e-4, msg=path)


def test_grad_accum_on_card(cuda):
    """accum 1 against 4 on one batch of granite's smoke config at bf16
    compute, JAX's bars: loss rtol 2e-4; parameters rtol 6e-3, atol 5e-4."""
    from repro_torch.models import params as prm
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import make_train_step
    cfg, _, card, batch = _train_twins(cuda, "granite-3-2b")
    cfg = cfg.replace(compute_dtype="bfloat16")
    batch = {k: v.to(cuda) for k, v in batch.items()}
    lr_fn = opt.warmup_cosine(1e-3, 5, 100)
    clone = lambda t: prm.tree_map(lambda a: a.clone(), t)  # noqa: E731
    p1, _, m1 = make_train_step(cfg, lr_fn, accum=1)(clone(card), opt.init(card), batch)
    p4, _, m4 = make_train_step(cfg, lr_fn, accum=4)(clone(card), opt.init(card), batch)
    assert abs(float(m1["loss"]) - float(m4["loss"])) <= 2e-4 * abs(float(m1["loss"]))
    for (_, a), (_, b) in zip(prm.leaf_paths(p1), prm.leaf_paths(p4)):
        torch.testing.assert_close(a, b, rtol=6e-3, atol=5e-4)


def test_resume_on_card_is_bitwise(cuda, tmp_path):
    """A 4-step run resumed from its step-3 checkpoint equals the
    uninterrupted run bit for bit on the card, twice-run equal too, and the
    checkpoint restores onto the CPU bit for bit."""
    import shutil
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import for_model
    from repro_torch.models import params as prm
    from repro_torch.train.train_loop import train
    cfg = get_config("granite-3-2b").smoke_config()
    pipe = for_model(cfg, seq_len=32, global_batch=4)
    kw = dict(steps=4, lr=1e-3, log_every=100, seed=2, device=cuda)
    ref = train(cfg, pipe, **kw)
    again = train(cfg, pipe, **kw)
    mgr = CheckpointManager(str(tmp_path), keep=5)
    train(cfg, pipe, ckpt_manager=mgr, ckpt_every=2, **kw)
    assert mgr.steps() == [1, 3, 4]
    cpu_p, cpu_s, _ = mgr.restore_train_state(cfg, device="cpu")
    shutil.rmtree(tmp_path / "ckpt_00000004")
    p, s, losses = train(cfg, pipe, ckpt_manager=mgr, ckpt_every=100, **kw)
    assert len(losses) == 1
    for run in (again, (p, s)):
        for a, b in zip((run[0], run[1].m, run[1].v), (ref[0], ref[1].m, ref[1].v)):
            for (pa, ta), (_, tb) in zip(prm.leaf_paths(a), prm.leaf_paths(b)):
                assert ta.device.type == "cuda" and torch.equal(ta, tb), pa
    for a, b in zip((cpu_p, cpu_s.m, cpu_s.v), (ref[0], ref[1].m, ref[1].v)):
        for (pa, ta), (_, tb) in zip(prm.leaf_paths(a), prm.leaf_paths(b)):
            assert ta.device.type == "cpu" and torch.equal(ta, tb.cpu()), pa


def test_compressed_all_reduce_of_cuda_tensors_over_gloo(cuda, tmp_path):
    """gloo's all-reduce of CUDA tensors (a one-rank group): the compressed
    reduce and three error-feedback steps equal the same calls on CPU
    copies bit for bit."""
    import torch.distributed as dist
    from repro_torch.train import grad_compress as gc
    g = torch.Generator().manual_seed(3)
    x = [torch.randn((2048, 2048), generator=g) for _ in range(3)]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        assert torch.equal(gc.compressed_all_reduce(x[0].to(cuda)).cpu(),
                           gc.compressed_all_reduce(x[0]))
        ec, eg = torch.zeros_like(x[0]), torch.zeros_like(x[0]).to(cuda)
        for xi in x:
            rc, ec = gc.compressed_all_reduce_with_feedback(xi, ec)
            rg, eg = gc.compressed_all_reduce_with_feedback(xi.to(cuda), eg)
            assert rg.device.type == "cuda"
            assert torch.equal(rg.cpu(), rc) and torch.equal(eg.cpu(), ec)
    finally:
        dist.destroy_process_group()


def test_train_asked_for_cuda_without_a_card_raises(cuda, monkeypatch):
    """No fallback: with no card found, train(device="cuda") raises before
    any step, and nothing runs on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import for_model
    from repro_torch.train.train_loop import train
    cfg = get_config("granite-3-2b").smoke_config()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    steps = []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(cfg, for_model(cfg, 16, 2), steps=2, device="cuda",
              on_log=lambda s, m: steps.append(s), log_every=1)
    assert steps == []


# ----------------------------------------------------------- sharded LM (PR 25)

def test_op_counter_counts_a_dtensors_local_work_on_card(cuda):
    """This torch's DTensor dispatch under the op analysis: a
    [Shard(0), Replicate()] × [Shard(0), Shard(1)] product of CUDA tensors
    on a fake (2, 2) group counts one rank's FLOPs (the global / 4) and
    DTensor's one all-gather of w's "data" shards (launch/op_analysis.py)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.op_analysis import analyze
    fake_group(4)
    try:
        mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
        x = DTensor.from_local(torch.ones((4, 64, 32), device=cuda), mesh,
                               [Shard(0), Replicate()], run_check=False)
        w = DTensor.from_local(torch.ones((16, 24), device=cuda), mesh,
                               [Shard(0), Shard(1)], run_check=False)
        r = analyze(lambda a, b: a @ b, x, w)
    finally:
        dist.destroy_process_group()
    assert r["flops"] == 2 * 8 * 64 * 32 * 48 / 4
    assert r["collectives"]["all-gather"] == {"count": 1.0, "bytes": 32 * 24 * 4}
    assert r["host_syncs"] == []


def test_sharded_serve_on_a_one_rank_mesh_on_card(cuda, tmp_path):
    """granite's smoke config (f32) over a (1, 1) mesh of one gloo rank on
    the card, its parameters and caches DTensors under the dry run's rules:
    prefill logits and three decode steps within 1e-5 of the plain path,
    ids equal, everything on the card."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import build_rules, set_mesh
    from repro_torch.models import transformer as TT
    from repro_torch.models.layers import set_logical_rules
    from repro_torch.models.params import distribute
    cfg = get_config("granite-3-2b").smoke_config().replace(compute_dtype="float32")
    params = TT.init_params(torch.Generator().manual_seed(0), cfg, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1))
    tokens = tokens.to(cuda)

    def run(p, wrap):
        logits, caches = TT.prefill(p, {"tokens": wrap(tokens)}, cfg, 24)
        out, tok = [logits], torch.argmax(logits[:, -1], -1)[:, None]
        for i in range(3):
            logits, caches = TT.decode_step(p, tok, caches, 16 + i, cfg)
            out.append(logits)
            tok = torch.argmax(logits[:, -1], -1)[:, None]
        return [o.full_tensor() if isinstance(o, DTensor) else o for o in out]

    with torch.no_grad():
        want = run(params, lambda t: t)
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                                world_size=1)
        rules = build_rules({}, batch_size=2, dp_degree=1)
        set_logical_rules(rules)
        try:
            mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
            with set_mesh(mesh):
                dp = distribute(params, TT.param_pspecs(cfg, rules), mesh)
                assert isinstance(dp["head"]["w"], DTensor)
                got = run(dp, lambda t: distribute({"t": t}, {"t": ("data", None)}, mesh)["t"])
        finally:
            set_logical_rules({})
            dist.destroy_process_group()
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert float((g - w).abs().max() / w.abs().max()) < 1e-5
        assert torch.equal(g.argmax(-1), w.argmax(-1))
