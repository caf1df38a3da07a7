"""The port's CUDA kernels and slice on the card (marker `cuda`).

Each kernel is held against its plain PyTorch version on CUDA tensors,
and the build + search slice on the card against the same slice on the
CPU (which tests/test_torch_slice.py holds against the JAX package). This
file imports nothing of JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

Without a card every test skips.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.core import (build_ivf_sharded, pack_ivf,  # noqa: E402
                              recall_at_k, search_jit_batched, true_neighbors)
from repro_torch.data.vectors import make_manifold  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.lloyd import lloyd_sweep  # noqa: E402
from repro_torch.kernels.pq_score import pq_score_window  # noqa: E402
from repro_torch.kernels.soar_assign import assign_fused, soar_assign  # noqa: E402
from repro_torch.kernels.vq_assign import vq_assign  # noqa: E402

pytestmark = pytest.mark.cuda


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("nq,cand,m", [(1, 7, 8), (8, 512, 16), (9, 1000, 50),
                                       (3, 37, 5), (2, 300, 160)])
def test_pq_score_window_matches_plain(cuda, nq, cand, m):
    luts = torch.from_numpy(_normal(60, nq, m, 16)).to(cuda)
    codes = torch.from_numpy(np.random.default_rng(61).integers(
        0, 16, (nq, cand, m)).astype(np.uint8)).to(cuda)
    n0 = pq_score_window.launches
    got = pq_score_window(luts, codes)
    torch.cuda.synchronize()
    assert pq_score_window.launches == n0 + 1
    torch.testing.assert_close(got, ref.pq_score_window_ref(luts, codes),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,c,d", [(100, 16, 32), (513, 100, 64),
                                   (64, 2000, 100), (1000, 777, 20), (70, 3, 5)])
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
        assert not bool((sidx == widx).any())


@pytest.mark.parametrize("n,c,d", [(1000, 16, 8), (3000, 64, 32), (5000, 300, 100)])
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


def test_wrapper_refuses_mixed_devices(cuda):
    with pytest.raises(ValueError, match="CUDA tensors"):
        vq_assign(torch.zeros((4, 3), device=cuda), torch.zeros((2, 3)))


def _to(idx, device):
    """The port's IVFIndex moved to another device."""
    return convert.index_from_numpy({
        "centroids": idx.centroids.cpu().numpy(), "starts": idx.starts.cpu().numpy(),
        "point_ids": idx.point_ids.cpu().numpy(), "codes": idx.codes.cpu().numpy(),
        "pq.centers": idx.pq.centers.cpu().numpy(),
        "rerank_f32": idx.rerank_f32.cpu().numpy(),
        "assignments": idx.assignments.cpu().numpy(), "n_points": idx.n_points,
        "spill_mode": idx.spill_mode, "lam": idx.lam}, device=device)


def test_slice_on_card_matches_cpu(cuda):
    """Build + search on the card, through the CUDA kernels, against the
    same slice on the CPU (n=20k, d=32, c=64, m=8)."""
    ds = make_manifold(0, 20_000, 32, nq=200, device="cpu")
    X, Q = ds.X, ds.Q
    launches0 = (vq_assign.launches, soar_assign.launches, lloyd_sweep.launches,
                 pq_score_window.launches)
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
        pq_score_window.launches)))


def test_assign_fused_on_card_matches_cpu(cuda):
    X, C = _normal(66, 3000, 48), _normal(67, 130, 48)
    for n_spills, lam in ((0, 0.0), (1, 0.0), (1, 1.0)):
        want = assign_fused(torch.from_numpy(X), torch.from_numpy(C), lam, n_spills)
        got = assign_fused(torch.from_numpy(X).to(cuda), torch.from_numpy(C).to(cuda),
                           lam, n_spills).cpu()
        assert float((got == want).all(dim=1).float().mean()) >= 0.999
