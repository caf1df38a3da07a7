"""The port's kernels (repro_torch.kernels) against the JAX package's Pallas
kernels in interpret mode, on the same numpy inputs.

On the CPU each wrapper takes its kernel's plain PyTorch version, so these
tests hold that version against the Pallas kernel body; the CUDA kernels
are held against the plain versions in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.soar import naive_spill_assign as jax_naive_spill  # noqa: E402
from repro.kernels import ops  # noqa: E402
from repro.kernels.lloyd import lloyd_sweep_pallas  # noqa: E402
from repro.kernels.soar_assign import _fused_assign_gemm as jax_fused_gemm  # noqa: E402
from repro.kernels.soar_assign import assign_fused as jax_assign_fused  # noqa: E402

from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.int8_rerank import int8_rerank  # noqa: E402
from repro_torch.kernels import kmeans_pp as kmeans_pp_mod  # noqa: E402
from repro_torch.kernels.kmeans_pp import kmeans_pp  # noqa: E402
from repro_torch.kernels import ops as torch_ops  # noqa: E402
from repro_torch.kernels.lloyd import lloyd_sweep  # noqa: E402
from repro_torch.kernels.pq_score import (pq_score, pq_score_probes,  # noqa: E402
                                          pq_score_probes_select)
from repro_torch.kernels.tree_route import tree_route  # noqa: E402
from repro_torch.kernels.soar_assign import assign_fused, soar_assign  # noqa: E402
from repro_torch.kernels.vq_assign import vq_assign  # noqa: E402
from repro_torch.quant.int8 import Int8Data  # noqa: E402
from test_torch_cuda import probe_case, select_case  # noqa: E402


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a, device="cpu"):
    return torch.from_numpy(np.array(a)).to(device)


def _unit_residuals(X, C, prim):
    r = X - C[prim]
    return (r / np.maximum(np.linalg.norm(r, axis=-1, keepdims=True),
                           1e-12)).astype(np.float32)


# -------------------------------------------------- kernel 1: dense PQ score
@pytest.mark.parametrize("nq,n,m", [
    (1, 64, 8), (7, 300, 16), (128, 512, 16), (33, 1000, 4), (2, 2048, 32),
])
def test_pq_score_matches_pallas(nq, n, m):
    luts = _normal(2, nq, m, 16)
    codes = np.random.default_rng(3).integers(0, 16, (n, m)).astype(np.uint8)
    want = np.asarray(ops.pq_score(jnp.asarray(luts), jnp.asarray(codes.astype(np.int32))))
    got = torch_ops.pq_score(_t(luts), _t(codes)).numpy()
    assert got.shape == (nq, n)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_pq_score_is_the_window_score_of_a_shared_window():
    """Every query scoring the same rows: the dense and window scores agree."""
    luts = _normal(4, 5, 6, 16)
    codes = np.random.default_rng(5).integers(0, 16, (70, 6)).astype(np.uint8)
    dense = pq_score(_t(luts), _t(codes))
    window = ref.pq_score_window_ref(_t(luts), _t(np.broadcast_to(codes, (5, 70, 6))))
    np.testing.assert_allclose(dense.numpy(), window.numpy(), rtol=1e-6, atol=1e-6)


# ------------------------------------------------- kernel 2: PQ window score
WINDOW_SHAPES = [(1, 7, 8), (8, 512, 16), (9, 1000, 50), (3, 37, 5)]


@pytest.mark.parametrize("nq,cand,m", WINDOW_SHAPES)
def test_pq_score_window_matches_pallas(nq, cand, m):
    """The plain window scorer under `ref.pq_score_probes_ref`."""
    luts = _normal(0, nq, m, 16)
    codes = np.random.default_rng(1).integers(0, 16, (nq, cand, m)).astype(np.uint8)
    want = np.asarray(ops.pq_score_window(jnp.asarray(luts),
                                          jnp.asarray(codes.astype(np.int32))))
    got = ref.pq_score_window_ref(_t(luts), _t(codes)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# (nq, t, c, pmax, m): ragged sizes, an empty and a full partition, a
# repeated and a starved probe in every case; pmax = 1; m in {5, 16, 50}
PROBE_CASES = [(3, 4, 6, 7, 5), (8, 5, 10, 33, 16), (4, 3, 5, 40, 50), (5, 2, 4, 1, 16),
               (2, 1, 3, 9, 50), (6, 6, 12, 20, 5)]


@pytest.mark.parametrize("nq,t,c,pmax,m", PROBE_CASES)
def test_pq_score_probes_matches_pallas_window(nq, t, c, pmax, m):
    """The probe scorer's plain version against the JAX package's search
    composition: the gathered window through the Pallas window kernel,
    plus the repeated coarse term, -inf where the slot is padding."""
    luts, codes, sizes, parts, psc = probe_case(nq, t, c, pmax, m)
    window = codes[parts].reshape(nq, t * pmax, m).astype(np.int32)
    scores = ops.pq_score_window(jnp.asarray(luts), jnp.asarray(window))
    scores = scores + jnp.repeat(jnp.asarray(psc), pmax, axis=-1)
    valid = (np.arange(pmax) < sizes[parts][..., None]).reshape(nq, t * pmax)
    want = np.asarray(jnp.where(jnp.asarray(valid), scores, -jnp.inf))
    got = pq_score_probes(*(_t(a) for a in (luts, codes, sizes, parts, psc))).numpy()
    assert got.shape == (nq, t * pmax)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.isneginf(got[-1, (t - 1) * pmax:]).all()    # the starved probe


# ------------------------------------------------ kernels 3, 4: assignment
ASSIGN_SHAPES = [(100, 16, 32), (513, 100, 64), (64, 2000, 100), (1000, 777, 20)]


def _agree(a, b):
    return float((np.asarray(a) == np.asarray(b)).mean())


@pytest.mark.parametrize("n,c,d", ASSIGN_SHAPES)
def test_vq_assign_matches_pallas(n, c, d):
    X, C = _normal(10, n, d), _normal(11, c, d)
    widx, wval = ops.vq_assign(jnp.asarray(X), jnp.asarray(C))
    gidx, gval = vq_assign(_t(X), _t(C))
    # f32 summation order can flip near-ties; chosen distances never differ
    assert _agree(gidx.numpy(), widx) >= 0.999
    np.testing.assert_allclose(gval.numpy(), np.asarray(wval), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,c,d,lam", [(200, 64, 32, 1.0), (513, 256, 64, 1.5),
                                       (100, 1000, 100, 0.5), (77, 3, 5, 2.0)])
def test_soar_assign_matches_pallas(n, c, d, lam):
    X, C = _normal(20, n, d), _normal(21, c, d)
    prim = np.asarray(ops.vq_assign(jnp.asarray(X), jnp.asarray(C))[0])
    rhat = _unit_residuals(X, C, prim)
    widx, wval = ops.soar_assign(jnp.asarray(X), jnp.asarray(rhat),
                                 jnp.asarray(prim), jnp.asarray(C), lam=lam)
    gidx, gval = soar_assign(_t(X), _t(rhat), _t(prim.astype(np.int32)), _t(C), lam)
    assert _agree(gidx.numpy(), widx) >= 0.999
    np.testing.assert_allclose(gval.numpy(), np.asarray(wval), rtol=1e-4, atol=1e-4)
    assert not np.any(gidx.numpy() == prim)


@pytest.mark.parametrize("n,c,d", [(128, 64, 16), (300, 130, 48)])
def test_soar_assign_lam0_is_naive_spill(n, c, d):
    X, C = _normal(22, n, d), _normal(23, c, d)
    prim, _ = vq_assign(_t(X), _t(C))
    rhat = _unit_residuals(X, C, prim.numpy())
    gidx, _ = soar_assign(_t(X), _t(rhat), prim, _t(C), lam=0.0)
    want = jax_naive_spill(jnp.asarray(X), jnp.asarray(C), jnp.asarray(prim.numpy()))
    assert _agree(gidx.numpy(), want) >= 0.999


@pytest.mark.parametrize("n_spills,lam", [(0, 0.0), (1, 0.0), (1, 1.0)])
def test_assign_fused_matches_jax(n_spills, lam):
    X, C = _normal(30, 700, 48), _normal(31, 130, 48)
    want = np.asarray(jax_assign_fused(jnp.asarray(X), jnp.asarray(C), lam=lam,
                                       n_spills=n_spills, chunk=256))
    got = assign_fused(_t(X), _t(C), lam=lam, n_spills=n_spills).numpy()
    assert got.shape == want.shape == (700, 1 + n_spills)
    for j in range(1 + n_spills):
        assert _agree(got[:, j], want[:, j]) >= 0.999


def test_assign_fused_multi_spill_is_later_work():
    """Multi-spill once raised here as later work; it is now held against
    JAX's `_fused_assign_gemm`: every column equal on >= 99.9% of rows,
    the columns of a row distinct."""
    X, C = _normal(0, 900, 24), _normal(1, 40, 24)
    for n_spills in (2, 3):
        want = np.asarray(jax_fused_gemm(jnp.asarray(X), jnp.asarray(C), lam=1.0,
                                         n_spills=n_spills, chunk=256))
        got = assign_fused(_t(X), _t(C), lam=1.0, n_spills=n_spills).numpy()
        assert got.shape == want.shape == (900, 1 + n_spills)
        for j in range(1 + n_spills):
            assert _agree(got[:, j], want[:, j]) >= 0.999
        srt = np.sort(got, axis=1)
        assert (srt[:, 1:] != srt[:, :-1]).all()


# ------------------------------------------------------- kernel 5: Lloyd
@pytest.mark.parametrize("n,c,d", [(1000, 16, 8), (3000, 64, 32), (2049, 100, 20)])
def test_lloyd_sweep_matches_pallas(n, c, d):
    X = _normal(40, n, d)
    C = X[np.random.default_rng(41).choice(n, c, replace=False)] + 0.01
    wC, wcnt, wdist = lloyd_sweep_pallas(jnp.asarray(X), jnp.asarray(C), c,
                                         interpret=True)
    gC, gcnt, gdist = lloyd_sweep(_t(X), _t(C))
    np.testing.assert_array_equal(gcnt.numpy(), np.asarray(wcnt))
    np.testing.assert_allclose(gC.numpy(), np.asarray(wC), rtol=1e-5, atol=1e-6)
    assert abs(float(gdist) - float(wdist)) <= 1e-5 * abs(float(wdist))


def test_lloyd_sweep_keeps_empty_centroid():
    X = _normal(42, 200, 6)
    C = np.concatenate([X[:4], np.full((1, 6), 50.0, np.float32)])
    wC, wcnt, _ = lloyd_sweep_pallas(jnp.asarray(X), jnp.asarray(C), 5,
                                     interpret=True)
    gC, gcnt, _ = lloyd_sweep(_t(X), _t(C))
    assert float(gcnt[4]) == float(wcnt[4]) == 0.0
    np.testing.assert_array_equal(gC.numpy()[4], C[4])


# ------------------------------------------------------------ the wrappers
def _launch_counts():
    return (pq_score.launches, pq_score_probes.launches, pq_score_probes_select.launches,
            vq_assign.launches, soar_assign.launches, lloyd_sweep.launches,
            tree_route.launches, kmeans_pp.launches)


def test_cpu_path_launches_nothing():
    before = _launch_counts()
    X, C = _t(_normal(50, 40, 8)), _t(_normal(51, 6, 8))
    assign_fused(X, C, lam=1.0, n_spills=1)
    lloyd_sweep(X, C)
    pq_score_probes(*(_t(a) for a in probe_case(2, 3, 4, 5, 3)))
    *sargs, bits = (_t(a) for a in select_case(2, 3, 4, 5, 3))
    pq_score_probes_select(*sargs, 4, bits)
    pq_score(_t(_normal(53, 2, 3, 16)), torch.zeros((5, 3), dtype=torch.uint8))
    tree_route(X, C, C[:, None].contiguous(), torch.arange(6, dtype=torch.int32)[:, None], 2)
    kmeans_pp(*_pp_case(2, 40, 8, 6))
    assert _launch_counts() == before


@pytest.mark.parametrize("which", ["pq", "select", "vq", "soar", "fused", "lloyd", "dense",
                                   "tree", "kmeans_pp", "int8_rerank"])
def test_non_cpu_tensor_never_falls_back(which):
    """A tensor that is not on the CPU must launch the kernel or raise;
    a meta tensor can do neither, so the wrapper must raise. The probe
    scorer takes all-meta inputs as a dry run (it returns its output's
    shape and reports its bytes, test_torch_launch_dryrun.py), so its
    case mixes a CPU tensor with meta ones."""
    X = torch.empty((8, 4), device="meta")
    C = torch.empty((3, 4), device="meta")
    calls = {
        "pq": lambda: pq_score_probes(
            torch.zeros((1, 2, 16)),
            torch.empty((3, 5, 2), dtype=torch.uint8, device="meta"),
            torch.empty(3, dtype=torch.int32, device="meta"),
            torch.empty((1, 2), dtype=torch.int64, device="meta"),
            torch.empty((1, 2), device="meta")),
        "select": lambda: pq_score_probes_select(
            torch.zeros((1, 2, 16)),
            torch.empty((3, 5, 2), dtype=torch.uint8, device="meta"),
            torch.empty(3, dtype=torch.int32, device="meta"),
            torch.empty((1, 2), dtype=torch.int64, device="meta"),
            torch.empty((1, 2), device="meta"),
            torch.empty((3, 5), dtype=torch.int32, device="meta"), 4),
        "vq": lambda: vq_assign(X, C),
        "soar": lambda: soar_assign(X, X, torch.empty(8, dtype=torch.int32,
                                                      device="meta"), C),
        "fused": lambda: assign_fused(X, C),
        "lloyd": lambda: lloyd_sweep(X, C),
        "dense": lambda: pq_score(torch.empty((1, 2, 16), device="meta"),
                                  torch.empty((5, 2), dtype=torch.uint8, device="meta")),
        "tree": lambda: tree_route(X, C, torch.empty((3, 2, 4), device="meta"),
                                   torch.empty((3, 2), dtype=torch.int32, device="meta"), 1),
        "kmeans_pp": lambda: kmeans_pp(torch.zeros((1, 8, 4)),
                                       torch.empty(1, dtype=torch.int64, device="meta"),
                                       torch.empty((3, 1), device="meta")),
        "int8_rerank": lambda: int8_rerank(
            torch.zeros((1, 4)),
            Int8Data(torch.empty((3, 4), dtype=torch.int8, device="meta"),
                     torch.empty(3, device="meta")),
            torch.empty((1, 2), dtype=torch.int32, device="meta"),
            torch.empty((1, 2), device="meta"), 1),
    }
    with pytest.raises(ValueError, match="CUDA tensors"):
        calls[which]()


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_library_name_follows_sources():
    p = _build.library_path()
    assert p.parent == _build.BUILD_DIR and p.name.startswith("libreprotorch_")
    assert {f.name for f in _build.CSRC.glob("*.cu")} == {
        "pq_score.cu", "pq_score_probes.cu", "vq_assign.cu", "soar_assign.cu",
        "lloyd.cu", "tree_route.cu", "kmeans_pp.cu", "int8_rerank.cu"}


# ------------------------------------------------ k-means++ seeding kernel
def _pp_case(m, n, d, c, seed=0):
    """Small integer coordinates (every f32 dot and norm exact in any
    order), each problem's first row and the (c − 1, m) uniforms."""
    g = torch.Generator().manual_seed(seed)
    X = torch.randint(-8, 9, (m, n, d), generator=g).float()
    return X, torch.randint(0, n, (m,), generator=g), torch.rand((c - 1, m), generator=g)


def test_kmeans_pp_on_the_cpu_is_the_plain_loop():
    """CPU tensors take the plain pick loop: the first row first, then
    distinct rows of each problem while any distance is left."""
    X, first, u = _pp_case(3, 500, 6, 40)
    got = kmeans_pp(X, first, u)
    assert got.shape == (3, 40, 6)
    assert torch.equal(got, ref.kmeans_pp_ref(X, first, u))
    assert torch.equal(got[:, 0], X[torch.arange(3), first])
    for p in range(3):
        rows = {r.numpy().tobytes() for r in X[p]}
        picked = [r.numpy().tobytes() for r in got[p]]
        assert set(picked) <= rows and len(set(picked)) == 40


@pytest.mark.parametrize("bad", ["X dtype", "first dtype", "X rank", "u width", "strided",
                                 "no rows"])
def test_kmeans_pp_rejects_what_the_kernel_does_not_take(bad):
    """The launch path checks its arguments before it takes a pointer."""
    X, first, u = _pp_case(2, 64, 4, 5)
    args = {"X dtype": (X.double(), first, u), "first dtype": (X, first.int(), u),
            "X rank": (X[0], first, u), "u width": (X, first, u[:, :1].contiguous()),
            "strided": (X[:, ::2], first, u), "no rows": (X[:, :0].contiguous(), first, u)}
    with pytest.raises(ValueError):
        kmeans_pp_mod._launch(*args[bad])


def test_kmeans_pp_on_meta_tensors_is_the_plain_loop():
    """A dry run's meta tensors take the plain loop: the centres' shape,
    no launch."""
    n0 = kmeans_pp.launches
    out = kmeans_pp(torch.empty((2, 100, 8), device="meta"),
                    torch.empty(2, dtype=torch.int64, device="meta"),
                    torch.empty((15, 2), device="meta"))
    assert out.device.type == "meta" and out.shape == (2, 16, 8)
    assert kmeans_pp.launches == n0


@pytest.mark.parametrize("n,scale", [(1, 2.0 ** 40), (2 ** 22 - 1, 2.0 ** 40),
                                     (2 ** 22, 2.0 ** 39), (2 ** 22 + 1, 2.0 ** 39)])
def test_d2_scale_keeps_the_integer_cdf_below_2_62(n, scale):
    """The scale the plain draw and the kernel share: 2**40 of a row's
    largest weight, halved from n = 2**22 on, so n truncated weights sum
    below 2**62."""
    assert ref.d2_scale(n) == scale
    assert n * scale * (1 + 2.0 ** -23) < 2.0 ** 62


@pytest.mark.parametrize("m,n,d", [(1, 32_768, 100), (1, 32_768, 96), (50, 32_768, 2),
                                   (1, 4096, 100), (1, 1_048_576, 96), (300, 50_000, 2),
                                   (1, 1, 1), (7, 100, 3), (1, 40, 5000)])
def test_kmeans_pp_plan_fits_the_card(m, n, d):
    """Every block of a team has rows, all blocks are resident at one an
    SM, rows in shared memory are an odd number of float4s, and the
    shared memory fits a block."""
    p = kmeans_pp_mod.plan(m, n, d, 132)
    assert p.teams == min(m, 132) and p.teams * p.blocks <= 132
    assert p.blocks <= kmeans_pp_mod.THREADS
    assert (p.blocks - 1) * p.rows < n <= p.blocks * p.rows
    assert p.stride4 % 2 == 1 and 4 * p.stride4 >= d
    assert 0 < p.smem <= kmeans_pp_mod.SMEM_LIMIT - kmeans_pp_mod.STATIC_SMEM
    assert p.xmode in (kmeans_pp_mod.X_SHARED, kmeans_pp_mod.X_GLOBAL)


def test_kmeans_pp_plan_follows_the_shape():
    """One problem takes the whole card with its rows in shared memory;
    PQ's 50 subspaces two blocks each; more problems than SMs a block
    each, with their state in device memory once it outgrows the block."""
    glove = kmeans_pp_mod.plan(1, 32_768, 100, 132)
    assert (glove.teams, glove.blocks, glove.rows) == (1, 132, 249)
    assert glove.xmode == kmeans_pp_mod.X_SHARED and glove.state_shared
    pq = kmeans_pp_mod.plan(50, 32_768, 2, 132)
    assert (pq.teams, pq.blocks, pq.xmode) == (50, 2, kmeans_pp_mod.X_GLOBAL)
    many = kmeans_pp_mod.plan(300, 50_000, 2, 132)
    assert (many.teams, many.blocks, many.state_shared) == (132, 1, 0)
    big = kmeans_pp_mod.plan(1, 1_048_576, 96, 132)
    assert big.xmode == kmeans_pp_mod.X_GLOBAL and big.state_shared
    with pytest.raises(ValueError, match="shared memory"):
        kmeans_pp_mod.plan(1, 100, 60_000, 132)
