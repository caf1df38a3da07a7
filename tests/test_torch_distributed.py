"""The port's shard-parallel search (repro_torch.core.distributed) against
the JAX package, on the CPU.

The JAX reference runs once, in a subprocess with 8 virtual CPU devices
(as tests/test_distributed.py runs it): it builds 8 shards of
`make_manifold` (n = 8,000, d = 32, 16 partitions a shard, PQ 8
subspaces, a tree router of 4 supers at t_route 3 each), stacks them, runs
every variant of both makers over an 8-device mesh (plain, filtered,
tree-routed, health all-ones and with shard 3 down, `params`, and all
three arguments together) and its two free builds at n = 16,000 for
keys 0-3 (tests/torch_recall.py), and writes one .npz. The port carries
the shards across with `convert.index_from_numpy` and runs the same
variants: stacked arrays bit for bit, ids on >= 0.995 of slots and
scores within 1e-5 where ids agree. In the main process: a one-shard
search against JAX's one-device mesh, `make_sharded_assign`, shard
envelopes written by either package and opened by the other, and
`torch.distributed` on gloo at world sizes 2 and 4 (ranks spawned as
processes, a file store in tmp_path) equal to the in-process result bit
for bit. Every subprocess has a time limit.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import distributed as jax_dist  # noqa: E402
from repro.core.build import build_ivf_sharded as jax_build  # noqa: E402
from repro.core.mutable import MutableIVF as JaxMutableIVF  # noqa: E402
from repro.serve.api import SearchParams as JaxSearchParams  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import distributed as dist_mod  # noqa: E402
from repro_torch.core.build import build_ivf_sharded  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    ShardedIVF, ShardedIVFPQ, ShardedTreeRouter, abstract_sharded_ivf,
    abstract_sharded_ivf_pq, build_sharded_ivf, build_sharded_ivf_pq,
    load_sharded, local_shards, make_distributed_search,
    make_distributed_search_pq, make_sharded_assign, save_sharded,
    shard_filters, sharded_from_indexes, sharded_from_indexes_pq,
    stack_filters, stack_tree_routers)
from repro_torch.core.kmr import recall_at_k  # noqa: E402
from repro_torch.core.mutable import MutableIVF  # noqa: E402
from repro_torch.kernels.soar_assign import assign_fused  # noqa: E402
from repro_torch.serve.api import SearchParams  # noqa: E402
from repro_torch.serve.health import HealthTracker  # noqa: E402

from torch_recall import SEEDS, assert_recall_means_close  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
D_SHARDS, NL, C, M, NQ = 8, 1_000, 16, 8, 64
T_SUB = 600          # seconds a subprocess may take
ENV = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
       "HOME": os.environ.get("HOME", str(ROOT)), "PYTHONPATH": str(ROOT / "src"),
       # force CPU: probing the image's libtpu costs 60 s or more
       "JAX_PLATFORMS": "cpu", "GLOO_SOCKET_IFNAME": "lo", "OMP_NUM_THREADS": "1"}

# the variants both packages run: (maker, kwargs, extra arguments)
VARIANTS = {
    "f32": ("f32", dict(top_t=8), ()),
    "pq": ("pq", dict(top_t=8), ()),
    "filtered_f32": ("f32", dict(top_t=10, with_filter=True), ("filt",)),
    "filtered_pq": ("pq", dict(top_t=10, with_filter=True), ("filt",)),
    "tree_f32": ("f32", dict(top_t=8, with_router=True, t_route=3), ("srt",)),
    "tree_pq": ("pq", dict(top_t=8, with_router=True, t_route=3), ("srt",)),
    "tree_default_t_route_pq": ("pq", dict(top_t=8, with_router=True), ("srt",)),
    "health_ones_f32": ("f32", dict(top_t=8, with_health=True), ("ones",)),
    "health_ones_pq": ("pq", dict(top_t=8, with_health=True), ("ones",)),
    "health_down_f32": ("f32", dict(top_t=8, with_health=True), ("down",)),
    "health_down_pq": ("pq", dict(top_t=8, with_health=True), ("down",)),
    "params_f32": ("f32", dict(top_t=99, params=dict(k=6, top_t=5)), ()),
    "params_pq": ("pq", dict(top_t=99, params=dict(k=6, top_t=5)), ()),
    "all_pq": ("pq", dict(top_t=8, with_filter=True, with_router=True,
                          with_health=True), ("filt", "srt", "down")),
}
PQ_KW = dict(rerank_k=128, q_chunk=32)

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.core import distributed as jd
from repro.core.build import build_ivf_sharded
from repro.core.kmr import true_neighbors
from repro.data.vectors import make_manifold
from repro.launch.mesh import set_mesh
from repro.serve.api import SearchParams
from repro.serve.health import HealthTracker

VARIANTS, PQ_KW, D, NL, C, M, NQ, SEEDS, out_path = eval(sys.argv[1])
out = {}
ds = make_manifold(jax.random.PRNGKey(0), n=D * NL, d=32, nq=NQ, intrinsic_dim=8)
X, Q = np.asarray(ds.X, np.float32), np.asarray(ds.Q, np.float32)
out["X"], out["Q"] = X, Q
idxs = [build_ivf_sharded(jax.random.fold_in(jax.random.PRNGKey(1), s),
                          X[s * NL:(s + 1) * NL], C, spill_mode="soar",
                          train_iters=4, pq_subspaces=M, router="tree",
                          router_kw=dict(n_super=4, t_route=3))
        for s in range(D)]
for s, idx in enumerate(idxs):
    for k in ("centroids", "starts", "point_ids", "codes", "rerank_f32",
              "assignments"):
        out[f"shard{s}.{k}"] = np.asarray(getattr(idx, k))
    out[f"shard{s}.pq.centers"] = np.asarray(idx.pq.centers)
    out[f"shard{s}.n_points"] = np.asarray(idx.n_points)
    r = idx.router
    out[f"shard{s}.router.super_centroids"] = np.asarray(r.super_centroids)
    out[f"shard{s}.router.children"] = np.asarray(r.children)
    out[f"shard{s}.router.child_centroids"] = np.asarray(r.child_centroids)
iv = jd.sharded_from_indexes(idxs)
ivq = jd.sharded_from_indexes_pq(idxs)
srt = jd.stack_tree_routers([i.router for i in idxs])
for name, tup in (("ivf", iv), ("ivfpq", ivq), ("srt", srt)):
    for f, a in zip(tup._fields, tup):
        out[f"{name}.{f}"] = np.asarray(a)
mask = np.random.default_rng(0).random(D * NL) < 0.2
out["mask"] = mask
filt = jd.shard_filters(mask, [NL] * D)
out["filt"] = np.asarray(filt)
out["stack_filters_padded"] = np.asarray(jd.stack_filters(
    [mask[s * NL:(s + 1) * NL][:NL - 7 * s] for s in range(D)], n_local_max=NL + 5))
h = HealthTracker(fail_threshold=1)
h.failure(3)
args = {"filt": filt, "srt": srt, "ones": jnp.ones((D,), jnp.uint8),
        "down": jnp.asarray(h.mask(D))}
mesh = jax.make_mesh((D,), ("data",))
for name, (maker, kw, extra) in VARIANTS.items():
    kw = dict(kw)
    if "params" in kw:
        kw["params"] = SearchParams(**kw["params"])
    if maker == "pq":
        fn = jd.make_distributed_search_pq(mesh, ("data",), **kw, **PQ_KW)
        a = (ivq,)
    else:
        fn = jd.make_distributed_search(mesh, ("data",), **kw)
        a = (iv,)
    with set_mesh(mesh):
        ids, sc = jax.jit(fn)(*a, jnp.asarray(Q), *(args[e] for e in extra))
    out[f"{name}.ids"], out[f"{name}.scores"] = np.asarray(ids), np.asarray(sc)

# the free builds of tests/test_distributed.py, at its size
ds = make_manifold(jax.random.PRNGKey(0), n=16_000, d=32, nq=NQ, intrinsic_dim=8)
X16, Q16 = np.asarray(ds.X, np.float32), np.asarray(ds.Q, np.float32)
gt = true_neighbors(X16, Q16, k=10)
out["X16"], out["Q16"], out["gt16"] = X16, Q16, gt
for kind in ("f32", "pq"):
    if kind == "pq":
        fn = jax.jit(jd.make_distributed_search_pq(mesh, ("data",), top_t=8, final_k=10,
                                                   **PQ_KW))
    else:
        fn = jax.jit(jd.make_distributed_search(mesh, ("data",), top_t=8, final_k=10))
    recalls = []
    for seed in SEEDS:
        if kind == "pq":
            sh = jd.build_sharded_ivf_pq(jax.random.PRNGKey(seed), X16, n_shards=D,
                                         n_partitions=C, pq_subspaces=M,
                                         spill_mode="soar", train_iters=5)
        else:
            sh = jd.build_sharded_ivf(jax.random.PRNGKey(seed), X16, n_shards=D,
                                      n_partitions=C, spill_mode="soar",
                                      train_iters=5)
        with set_mesh(mesh):
            ids, _ = fn(sh, jnp.asarray(Q16))
        ids = np.asarray(ids)
        recalls.append((ids[:, :, None] == gt[:, None, :]).any(-1).mean())
    out[f"free_{kind}.recalls"] = np.asarray(recalls)
    out[f"free_{kind}.recall_mean"] = np.asarray(np.mean(recalls))
np.savez(out_path, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's shards and every variant's output (one subprocess
    with 8 virtual CPU devices)."""
    path = tmp_path_factory.mktemp("jax_distributed") / "ref.npz"
    arg = repr((VARIANTS, PQ_KW, D_SHARDS, NL, C, M, NQ, SEEDS, str(path)))
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT, arg], cwd=ROOT, env=ENV,
                       capture_output=True, text=True, timeout=T_SUB)
    assert r.returncode == 0 and "OK" in r.stdout, (r.stdout[-2000:], r.stderr[-4000:])
    return dict(np.load(path))


def _shard_fields(ref, s):
    """Shard s of the reference as the fields convert.index_from_numpy takes."""
    f = {k[len(f"shard{s}."):]: v for k, v in ref.items() if k.startswith(f"shard{s}.")}
    f.update(n_points=int(f["n_points"]), spill_mode="soar", lam=1.0,
             router={"type": "tree", "t_route": 3, "n_partitions": C})
    return f


@pytest.fixture(scope="module")
def shards(ref):
    return [convert.index_from_numpy(_shard_fields(ref, s), device="cpu")
            for s in range(D_SHARDS)]


@pytest.fixture(scope="module")
def stacks(shards):
    return (sharded_from_indexes(shards), sharded_from_indexes_pq(shards),
            stack_tree_routers([i.router for i in shards]))


def _health_down():
    h = HealthTracker(fail_threshold=1)
    h.failure(3)
    return h.mask(D_SHARDS)


def _args(ref, stacks):
    return {"filt": shard_filters(ref["mask"], [NL] * D_SHARDS), "srt": stacks[2],
            "ones": np.ones(D_SHARDS, np.uint8), "down": _health_down()}


def _maker(maker, kw, **placement):
    kw = dict(kw)
    if "params" in kw:
        kw["params"] = SearchParams(**kw["params"])
    if maker == "pq":
        return make_distributed_search_pq(**placement, **kw, **PQ_KW)
    return make_distributed_search(**placement, **kw)


def _run_variant(name, ref, stacks, **placement):
    maker, kw, extra = VARIANTS[name]
    args = _args(ref, stacks)
    fn = _maker(maker, kw, **placement)
    ivf = stacks[1] if maker == "pq" else stacks[0]
    return fn(ivf, ref["Q"], *(args[e] for e in extra))


def _agree(a, b):
    return float((np.asarray(a) == np.asarray(b)).mean())


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- stacking
def test_stacked_arrays_match_jax(ref, stacks):
    iv, ivq, srt = stacks
    for name, tup in (("ivf", iv), ("ivfpq", ivq), ("srt", srt)):
        for f in tup._fields:
            if f == "extent":
                continue
            got, want = getattr(tup, f).numpy(), ref[f"{name}.{f}"]
            assert got.dtype == want.dtype and np.array_equal(got, want), (name, f)
    # the extent: the last slot with an id >= 0, plus one (a packed CSR
    # index has no -1 inside a partition, so it is the size)
    assert torch.equal(ivq.extent, ivq.sizes)
    assert ivq.extent.dtype == torch.int32 and ivq.extent.shape == ivq.sizes.shape
    assert isinstance(iv, ShardedIVF) and isinstance(ivq, ShardedIVFPQ)
    assert isinstance(srt, ShardedTreeRouter)


def test_filters_match_jax(ref):
    mask = ref["mask"]
    got = shard_filters(mask, [NL] * D_SHARDS)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), ref["filt"])
    got = stack_filters([mask[s * NL:(s + 1) * NL][:NL - 7 * s] for s in range(D_SHARDS)],
                        n_local_max=NL + 5)
    assert np.array_equal(got.numpy(), ref["stack_filters_padded"])
    # tensors stay tensors, on their device
    assert np.array_equal(shard_filters(_t(mask), [NL] * D_SHARDS).numpy(), ref["filt"])


@pytest.mark.parametrize("n", [D_SHARDS * NL - 1, D_SHARDS * NL + 3])
def test_shard_filters_refuses_a_mask_of_the_wrong_length(n):
    mask = np.ones(n, bool)
    msg = f"global mask covers {n} ids but shards hold {D_SHARDS * NL}"
    with pytest.raises(AssertionError, match=msg):
        jax_dist.shard_filters(mask, [NL] * D_SHARDS)
    with pytest.raises(ValueError, match=msg):
        shard_filters(mask, [NL] * D_SHARDS)


@pytest.mark.parametrize("c,pmax,m", [(16, 181, 8), (5, 7, 3), (2500, 3, 25)])
def test_code_blocks_start_on_16_bytes(c, pmax, m):
    """The probe scorer refuses a table that does not start on 16 bytes;
    at m = 25, c = 2,500 a plain (D, c, pmax, m) stack puts shard 1 off it
    unless pmax is a multiple of 4. Every stack, copy and block keeps its
    shards on 16 bytes and equal to the plain stack."""
    rng = np.random.default_rng(c)
    tables = [_t(rng.integers(0, 16, (c, pmax, m)).astype(np.uint8)) for _ in range(3)]
    codes = dist_mod._aligned_codes(tables, torch.device("cpu"))
    plain = torch.stack(tables)
    assert torch.equal(codes, plain)

    def aligned(x):
        return all(x[s].data_ptr() % 16 == 0 and x[s].is_contiguous()
                   for s in range(x.shape[0]))

    assert aligned(codes)
    again = dist_mod._aligned_codes(codes[1:], torch.device("cpu"))
    assert aligned(again) and torch.equal(again, plain[1:])


def test_abstract_stacks_have_jax_shapes_and_dtypes():
    a = abstract_sharded_ivf(8, 125_000, 2_500, 1_024, 100)
    j = jax_dist.abstract_sharded_ivf(8, 125_000, 2_500, 1_024, 100)
    b = abstract_sharded_ivf_pq(8, 125_000, 2_500, 1_024, 100, 25)
    jb = jax_dist.abstract_sharded_ivf_pq(8, 125_000, 2_500, 1_024, 100, 25)
    for got, want in list(zip(a, j)) + list(zip(b, jb)):
        assert got.device.type == "meta"
        assert tuple(got.shape) == tuple(want.shape)
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert tuple(b.extent.shape) == (8, 2_500) and b.extent.dtype == torch.int32


# ------------------------------------------------------------------ search
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_search_matches_jax(ref, stacks, name):
    ids, sc = _run_variant(name, ref, stacks)
    want_i, want_s = ref[f"{name}.ids"], ref[f"{name}.scores"]
    ids, sc = ids.numpy(), sc.numpy()
    assert ids.dtype == np.int32 and ids.shape == want_i.shape
    assert _agree(ids, want_i) >= 0.995, name
    same = (ids == want_i) & np.isfinite(want_s)
    np.testing.assert_allclose(sc[same], want_s[same], rtol=1e-5, atol=1e-5)
    assert np.array_equal(np.isfinite(sc), np.isfinite(want_s))
    if "filt" in VARIANTS[name][2]:
        assert ref["mask"][ids[ids >= 0]].all(), "a result violated the filter"


@pytest.mark.parametrize("maker", ["f32", "pq"])
def test_health_all_ones_is_bitwise_and_down_shard_leaks_nothing(ref, stacks, maker):
    """tests/test_resilience.py::test_degraded_shard_fanout_multidevice on the
    carried-across shards: an all-ones mask gives the bits of the search
    without health; with shard 3 down no id of its range comes back, no
    -1, and every healthy shard's answer survives into the top k."""
    plain = _run_variant(maker, ref, stacks)
    ones = _run_variant(f"health_ones_{maker}", ref, stacks)
    down = _run_variant(f"health_down_{maker}", ref, stacks)
    assert torch.equal(plain[0], ones[0]) and torch.equal(plain[1], ones[1])
    ids0, ids2 = plain[0].numpy(), down[0].numpy()
    lo, hi = 3 * NL, 4 * NL
    assert ids2.min() >= 0
    assert not ((ids2 >= lo) & (ids2 < hi)).any(), "dead shard leaked results"
    keep = ~((ids0 >= lo) & (ids0 < hi))
    for q in range(ids0.shape[0]):
        assert set(ids0[q][keep[q]].tolist()) <= set(ids2[q].tolist()), q


def test_degraded_shard_fanout_on_a_free_build():
    """tests/test_resilience.py::test_degraded_shard_fanout_multidevice
    (its data shape: n = 8,000, d = 16, 8 shards) on the port's own build."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((8_000, 16)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    Q = rng.standard_normal((16, 16)).astype(np.float32)
    sharded = build_sharded_ivf(1, X, n_shards=8, n_partitions=16, train_iters=3,
                                device="cpu")
    ids0, sc0 = make_distributed_search(top_t=8, final_k=10)(sharded, Q)
    degr = make_distributed_search(top_t=8, final_k=10, with_health=True)
    ids1, sc1 = degr(sharded, Q, np.ones(8, np.uint8))
    assert torch.equal(ids0, ids1) and torch.equal(sc0, sc1), "healthy != plain"
    ids2, _ = degr(sharded, Q, _health_down())
    ids0, ids2 = ids0.numpy(), ids2.numpy()
    assert ids2.min() >= 0
    assert not ((ids2 >= 3_000) & (ids2 < 4_000)).any()
    keep = ~((ids0 >= 3_000) & (ids0 < 4_000))
    for q in range(ids0.shape[0]):
        assert set(ids0[q][keep[q]].tolist()) <= set(ids2[q].tolist()), q


@pytest.mark.parametrize("kind", ["f32", "pq"])
def test_free_builds_meet_jax_recall(ref, kind):
    """tests/test_distributed.py's bars on each of the port's own builds (its
    random streams are not JAX's), and the mean recall over seeds 0-3 within
    0.02 of JAX's builds' mean (tests/torch_recall.py)."""
    X, Q, gt = ref["X16"], ref["Q16"], _t(ref["gt16"])

    def port(seed):
        if kind == "pq":
            sh = build_sharded_ivf_pq(seed, X, n_shards=8, n_partitions=C, pq_subspaces=M,
                                      train_iters=5, device="cpu")
            ids, _ = make_distributed_search_pq(top_t=8, final_k=10, **PQ_KW)(sh, Q)
            bar = 0.75
        else:
            sh = build_sharded_ivf(seed, X, n_shards=8, n_partitions=C, train_iters=5,
                                   device="cpu")
            ids, _ = make_distributed_search(top_t=8, final_k=10)(sh, Q)
            bar = 0.80
        rec = float(recall_at_k(ids, gt, 10))
        assert rec > bar, (seed, rec)
        assert ids.min() >= 0 and ids.max() < 16_000
        for row in ids.numpy():
            assert len(set(row.tolist())) == len(row)
        return rec

    assert_recall_means_close(port, ref[f"free_{kind}.recalls"])


def test_free_build_shard_seeds_are_documented_generators():
    rng = np.random.default_rng(3)
    X = rng.standard_normal((600, 8)).astype(np.float32)
    sh = build_sharded_ivf_pq(7, X, n_shards=2, n_partitions=4, pq_subspaces=2,
                              train_iters=2, device="cpu")
    idxs = [build_ivf_sharded(dist_mod.shard_generator(7, s), X[s * 300:(s + 1) * 300],
                              4, pq_subspaces=2, train_iters=2, device="cpu")
            for s in range(2)]
    for a, b in zip(sh, sharded_from_indexes_pq(idxs)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="equal shards"):
        build_sharded_ivf(7, X[:599], n_shards=2, n_partitions=4, device="cpu")


def test_placement_over_devices_and_tiles_keep_the_bits(ref, stacks):
    """Shards spread over a list of devices (one may repeat) give the bits
    of the default placement, and a query's bits do not depend on the
    batch it comes in (every tile runs at TILE_ROWS rows)."""
    for name in ("pq", "tree_f32", "all_pq"):
        a = _run_variant(name, ref, stacks)
        b = _run_variant(name, ref, stacks, devices=["cpu", "cpu", "cpu"])
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), name
    fn = make_distributed_search_pq(top_t=8, rerank_k=128, q_chunk=1)
    whole = fn(stacks[1], ref["Q"])
    part = fn(stacks[1], ref["Q"][5:8])
    assert torch.equal(whole[0][5:8], part[0]) and torch.equal(whole[1][5:8], part[1])


def test_makers_check_their_arguments(ref, stacks):
    fn = make_distributed_search_pq(top_t=8, q_chunk=32)
    with pytest.raises(ValueError, match="q_chunk=32"):
        fn(stacks[1], ref["Q"][:40])
    with pytest.raises(TypeError, match="expected 1 argument"):
        make_distributed_search(top_t=8, with_filter=True)(stacks[0], ref["Q"])
    with pytest.raises(ValueError, match="do not split"):
        make_sharded_assign(["cpu", "cpu"])(np.zeros((5, 4), np.float32),
                                            np.zeros((3, 4), np.float32))


# -------------------------------------------------------- single-device JAX
def _jax_fields(idx):
    return {"centroids": np.asarray(idx.centroids), "starts": idx.starts,
            "point_ids": idx.point_ids, "codes": idx.codes,
            "pq.centers": None if idx.pq is None else np.asarray(idx.pq.centers),
            "rerank_f32": idx.rerank_f32, "assignments": idx.assignments,
            "n_points": idx.n_points, "spill_mode": idx.spill_mode, "lam": idx.lam}


def test_one_shard_matches_jax_one_device_mesh_and_takes_params(ref):
    """tests/test_serve_api.py::test_shard_parallel_maker_takes_params with
    JAX's one-device mesh in this process."""
    X, Q = ref["X"][:4_000], ref["Q"]
    jidx = jax_build(jax.random.PRNGKey(2), X, 16, train_iters=4, pq_subspaces=M)
    jsh = jax_dist.sharded_from_indexes([jidx])
    jshq = jax_dist.sharded_from_indexes_pq([jidx])
    mesh = jax.make_mesh((1,), ("data",))
    idx = convert.index_from_numpy(_jax_fields(jidx), device="cpu")
    sh, shq = sharded_from_indexes([idx]), sharded_from_indexes_pq([idx])
    for a, b in list(zip(sh, jsh)) + list(zip(shq, jshq)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for maker, jmaker, s, js, kw in (
            (make_distributed_search, jax_dist.make_distributed_search, sh, jsh, {}),
            (make_distributed_search_pq, jax_dist.make_distributed_search_pq, shq, jshq,
             PQ_KW)):
        f_kw = maker(top_t=6, final_k=5, **kw)
        f_p = maker(top_t=1, params=SearchParams(k=5, top_t=6), **kw)
        ids_a, sc_a = f_kw(s, Q)
        ids_b, sc_b = f_p(s, Q)
        assert torch.equal(ids_a, ids_b) and torch.equal(sc_a, sc_b)
        jf = jmaker(mesh, ("data",), top_t=1, params=JaxSearchParams(k=5, top_t=6), **kw)
        jids, jsc = (np.asarray(a) for a in jax.jit(jf)(js, jnp.asarray(Q)))
        assert _agree(ids_a.numpy(), jids) >= 0.995
        same = ids_a.numpy() == jids
        np.testing.assert_allclose(sc_a.numpy()[same], jsc[same], rtol=1e-5, atol=1e-5)


def test_sharded_assign_equals_assign_fused_and_jax(ref):
    """tests/test_build.py::test_sharded_assign_shard_map's case: the fan-out
    over two (CPU) devices equals one assign_fused call bit for bit, and
    JAX's shard_map assignment over its one-device mesh."""
    from jax.sharding import Mesh
    X = ref["X"][:4_000]
    cb = ref["shard0.centroids"]
    fn = make_sharded_assign(["cpu", "cpu"], lam=1.0, n_spills=1, chunk=512)
    got = fn(X, cb)
    assert got.dtype == torch.int32 and got.shape == (4_000, 2)
    assert torch.equal(got, assign_fused(_t(X), _t(cb), lam=1.0, n_spills=1))
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jfn = jax_dist.make_sharded_assign(mesh, ("data",), lam=1.0, n_spills=1, chunk=512)
    want = np.asarray(jfn(jnp.asarray(X), jnp.asarray(cb)))
    assert np.array_equal(got.numpy(), want)
    for mode, cols in (("none", 1), ("naive", 2)):
        g = make_sharded_assign(["cpu"] * 4, spill_mode=mode)(X, cb)
        assert g.shape == (4_000, cols)


# --------------------------------------------------------------- envelopes
def _envelope_shards(rng):
    X = rng.normal(size=(512, 8)).astype(np.float32)
    return X, [jax_build(jax.random.PRNGKey(s), X[s * 256:(s + 1) * 256], 8,
                         pq_subspaces=2) for s in range(2)]


def test_sharded_envelope_roundtrip(tmp_path):
    """tests/test_durability.py::test_sharded_envelope_roundtrip, ported:
    a MutableIVF shard after an add, saved, loaded and re-stacked bit for
    bit, and searched to the same bits."""
    rng = np.random.default_rng(0)
    _, jshards = _envelope_shards(rng)
    shards = [convert.index_from_numpy(_jax_fields(j), device="cpu") for j in jshards]
    shards[0] = MutableIVF.from_index(shards[0])
    shards[0].add(rng.normal(size=(10, 8)).astype(np.float32))
    s0 = sharded_from_indexes_pq(shards)
    p = str(tmp_path / "shards")
    save_sharded(p, shards, extra={"note": 1})
    loaded, extra = load_sharded(p, device="cpu")
    assert extra == {"note": 1}
    s1 = sharded_from_indexes_pq(loaded)
    for a, b in zip(s0, s1):
        assert torch.equal(a, b)
    Q = rng.normal(size=(8, 8)).astype(np.float32)
    fn = make_distributed_search_pq(top_t=4, final_k=5, q_chunk=8)
    a, b = fn(s0, Q), fn(s1, Q)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_jax_envelope_opens_in_port_and_port_envelope_in_jax(tmp_path):
    rng = np.random.default_rng(1)
    _, jshards = _envelope_shards(rng)
    jshards[1] = JaxMutableIVF.from_index(jshards[1])
    jshards[1].add(rng.normal(size=(7, 8)).astype(np.float32))
    jstack = jax_dist.sharded_from_indexes_pq(jshards)
    pj = str(tmp_path / "jax_env")
    jax_dist.save_sharded(pj, jshards, extra={"by": "jax"})
    loaded, extra = load_sharded(pj, device="cpu")
    assert extra == {"by": "jax"} and isinstance(loaded[1], MutableIVF)
    stack = sharded_from_indexes_pq(loaded)
    for a, b in zip(stack, jstack):
        assert np.array_equal(a.numpy(), np.asarray(b))
    pp = str(tmp_path / "port_env")
    save_sharded(pp, loaded, extra={"by": "port"})
    back, extra = jax_dist.load_sharded(pp)
    assert extra == {"by": "port"}
    for a, b in zip(jax_dist.sharded_from_indexes_pq(back), stack):
        assert np.array_equal(np.asarray(a), b.numpy())
    for a, b in zip(jax_dist.sharded_from_indexes(back), sharded_from_indexes(loaded)):
        assert np.array_equal(np.asarray(a), b.numpy())


# -------------------------------------------------------- torch.distributed
RANK_SCRIPT = r"""
import sys
from datetime import timedelta
import numpy as np, torch, torch.distributed as dist
from repro_torch.core.distributed import (load_sharded, local_shards,
    make_distributed_search, make_distributed_search_pq, sharded_from_indexes,
    sharded_from_indexes_pq, stack_tree_routers)
rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                        world_size=world, timeout=timedelta(seconds=120))
g = dist.group.WORLD
shards, _ = load_sharded(f"{tmp}/env", device="cpu")
iv = local_shards(sharded_from_indexes(shards), g)
ivq = local_shards(sharded_from_indexes_pq(shards), g)
srt = local_shards(stack_tree_routers([s.router for s in shards]), g)
inp = np.load(f"{tmp}/inputs.npz")
Q, filt, down = inp["Q"], local_shards(inp["filt"], g), local_shards(inp["down"], g)
kw = dict(rerank_k=128, q_chunk=32, group=g)
out = {
    "f32": make_distributed_search(top_t=8, group=g)(iv, Q),
    "tree_f32": make_distributed_search(top_t=8, with_router=True, group=g)(iv, Q, srt),
    "pq": make_distributed_search_pq(top_t=8, **kw)(ivq, Q),
    "all_pq": make_distributed_search_pq(top_t=8, with_filter=True, with_router=True,
                                         with_health=True, **kw)(ivq, Q, filt, srt, down),
}
torch.save(out, f"{tmp}/rank{rank}.pt")
dist.destroy_process_group()
print("OK", rank)
"""


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_ranks_equal_the_in_process_search(ref, shards, stacks, tmp_path, world):
    save_sharded(str(tmp_path / "env"), shards)
    args = _args(ref, stacks)
    np.savez(tmp_path / "inputs.npz", Q=ref["Q"], filt=args["filt"].numpy(),
             down=args["down"])
    procs = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, str(r), str(world),
                               str(tmp_path)], cwd=ROOT, env=ENV,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    try:
        outs = [p.communicate(timeout=T_SUB) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0 and "OK" in o, e[-3000:]
    iv, ivq, srt = stacks
    want = {
        "f32": make_distributed_search(top_t=8)(iv, ref["Q"]),
        "tree_f32": make_distributed_search(top_t=8, with_router=True)(iv, ref["Q"], srt),
        "pq": _run_variant("pq", ref, stacks),
        "all_pq": _run_variant("all_pq", ref, stacks),
    }
    for r in range(world):
        got = torch.load(tmp_path / f"rank{r}.pt")
        for k, (i, s) in want.items():
            assert torch.equal(got[k][0], i) and torch.equal(got[k][1], s), (r, k)


def test_local_shards_is_the_rank_block(stacks, tmp_path):
    """One rank of one: the block is the whole stack, copied, its code
    blocks on 16 bytes."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        g = dist.group.WORLD
        ivq = stacks[1]
        blk = local_shards(ivq, g)
        for a, b in zip(blk, ivq):
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
        assert all(blk.part_codes[s].data_ptr() % 16 == 0 for s in range(D_SHARDS))
        assert np.array_equal(local_shards(np.arange(8), g), np.arange(8))
    finally:
        dist.destroy_process_group()
