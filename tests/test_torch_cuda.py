"""The port's CUDA kernels and slices on the card (marker `cuda`).

Each kernel is held against its plain PyTorch version on CUDA tensors,
and the build + search slice, the tree-routed filtered search and the
serving slice (online inserts, the pruned router, the delta pack, the host
engine), snapshots and log replay onto the card, and the KMR curve on the
card against the same slices on the CPU (which tests/test_torch_slice.py,
test_torch_router.py, test_torch_filtered.py, test_torch_durability.py
and test_torch_kmr.py hold against the JAX package). This
file imports nothing of JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

Without a card every test skips.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.ckpt import load_snapshot, save_snapshot  # noqa: E402
from repro_torch.core import (build_ivf, build_ivf_sharded, kmr_curve,  # noqa: E402
                              pack_ivf, rank_statistics, recall_at_k,
                              search_jit_batched, true_neighbors)
from repro_torch.core.kmeans import train_kmeans  # noqa: E402
from repro_torch.core.mutable import MutableIVF  # noqa: E402
from repro_torch.core.router import TreeRouter  # noqa: E402
from repro_torch.core.search import search_numpy  # noqa: E402
from repro_torch.core.soar import naive_spill_assign  # noqa: E402
from repro_torch.data.vectors import make_manifold  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import lloyd as lloyd_mod  # noqa: E402
from repro_torch.kernels.lloyd import lloyd_sweep  # noqa: E402
from repro_torch.kernels.pq_score import pq_score, pq_score_probes  # noqa: E402
from repro_torch.kernels.soar_assign import assign_fused, soar_assign  # noqa: E402
from repro_torch.kernels.tree_route import tree_route  # noqa: E402
from repro_torch.kernels.vq_assign import vq_assign  # noqa: E402
from repro_torch.quant.anisotropic import anisotropic_assign, eta_from_threshold  # noqa: E402
from repro_torch.quant.int8 import int8_quantize  # noqa: E402
from repro_torch.serve.engine import AnnEngine  # noqa: E402

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


# the CPU cases of test_torch_kernels.py, then a search tile (nq = 128) at
# t = 1, 40 (the flat probe) and 80 (its escalation), partitions of up to
# 1,506 rows (odd pmax: every head alignment), and m = 160
@pytest.mark.parametrize("nq,t,c,pmax,m", [
    (3, 4, 6, 7, 5), (8, 5, 10, 33, 16), (4, 3, 5, 40, 50), (5, 2, 4, 1, 16),
    (2, 1, 3, 9, 50), (6, 6, 12, 20, 5),
    (128, 1, 50, 1501, 50), (128, 40, 200, 1506, 50), (128, 80, 200, 1501, 50),
    (7, 9, 30, 333, 160)])
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


def test_pq_score_probes_refuses_a_misaligned_table(cuda):
    luts, codes, sizes, parts, psc = (torch.from_numpy(a).to(cuda)
                                      for a in probe_case(2, 3, 4, 5, 4))
    shifted = torch.zeros(codes.numel() + 1, dtype=torch.uint8, device=cuda)[1:]
    with pytest.raises(ValueError, match="16-byte"):
        pq_score_probes(luts, shifted.view(codes.shape), sizes, parts, psc)


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
    """The port's IVFIndex, its tree router included, moved to another device."""
    fields = {
        "centroids": idx.centroids.cpu().numpy(), "starts": idx.starts.cpu().numpy(),
        "point_ids": idx.point_ids.cpu().numpy(), "codes": idx.codes.cpu().numpy(),
        "pq.centers": idx.pq.centers.cpu().numpy(),
        "rerank_f32": idx.rerank_f32.cpu().numpy(),
        "assignments": idx.assignments.cpu().numpy(), "n_points": idx.n_points,
        "spill_mode": idx.spill_mode, "lam": idx.lam}
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
                 pq_score_probes.launches)
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
    # free build on the card (Lloyd kernel included)
    free = build_ivf_sharded(torch.Generator().manual_seed(0), X, 64,
                             pq_subspaces=8, device=cuda)
    ids2, _ = search_jit_batched(pack_ivf(free), Q, **kw)
    gt = true_neighbors(X, Q, k=10)
    assert abs(recall_at_k(ids2.cpu(), gt, 10) - recall_at_k(ids0, gt, 10)) <= 0.02
    assert all(b > a for a, b in zip(launches0, (
        vq_assign.launches, soar_assign.launches, lloyd_sweep.launches,
        pq_score_probes.launches)))


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
