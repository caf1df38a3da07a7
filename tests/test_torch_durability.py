"""The port's durable index lifecycle (repro_torch.ckpt, MutableIVF's log
hooks, AnnEngine.save / open, repro_torch.faults) on the CPU.

Against the JAX package: a JAX `MutableIVF` carried across with
`convert.mutable_from_numpy` and its port twin go through one mutation
script; their snapshots (`MutableIVF` and `IVFIndex`) are byte-identical
and their logs too, and each package opens and replays what the other
wrote (`PackedIVF` included). Inside the port: the JAX package's round
trips, corruption cases, log unit tests, crash matrices (every crash point
reopens bit for bit to the last committed state or the next one) and its
two true-crash subprocesses, injecting through `repro_torch.faults`; the
serving points; the `KNNMemory` kind refused by name. n <= 2,000, d = 16,
inputs made by numpy from a seed.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import faults as jax_faults  # noqa: E402
from repro.ckpt import index_store as jax_store  # noqa: E402
from repro.ckpt.wal import MutationWAL as JaxMutationWAL  # noqa: E402
from repro.core import search as jax_search  # noqa: E402
from repro.core.mutable import MutableIVF as JaxMutableIVF  # noqa: E402
from repro.serve.engine import AnnEngine as JaxAnnEngine  # noqa: E402

from repro_torch import convert, faults  # noqa: E402
from repro_torch.ckpt import (CorruptSnapshotError, MutationWAL,  # noqa: E402
                              load_shards, load_snapshot, save_shards,
                              save_snapshot)
from repro_torch.ckpt import index_store  # noqa: E402
from repro_torch.ckpt.faults import InjectedCrash  # noqa: E402
from repro_torch.ckpt.wal import (REC_ADD, REC_COMPACT, REC_HARDEN,  # noqa: E402
                                  REC_REMOVE, read_records)
from repro_torch.core import search_jit, search_numpy  # noqa: E402
from repro_torch.serve.engine import AnnEngine  # noqa: E402

D, K = 16, 5
N0, C, M = 1500, 16, 4
STATE = ("part_ids", "part_codes", "sizes", "rerank", "assignments", "alive")
COUNTS = ("n_total", "n_dead_slots", "n_soft_deleted", "wal_seq")
SEARCH = dict(top_t=6, final_k=K, rerank_budget=64)


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    faults.uninstall()
    jax_faults.uninstall()


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="module")
def queries(rng):
    return rng.normal(size=(12, D)).astype(np.float32)


# ------------------------------------------------------------ helpers
def mutable_fields(m):
    """A JAX MutableIVF's state as convert.mutable_from_numpy's fields."""
    f = {k: getattr(m, k) for k in STATE + COUNTS + (
        "centroids", "spill_mode", "lam", "n_spills", "compact_threshold")}
    f["pq.centers"] = None if m.pq is None else np.asarray(m.pq.centers)
    rt = m.router
    f.update({"router": {"type": "tree", "t_route": rt.t_route,
                         "n_partitions": rt.n_partitions},
              "router.super_centroids": np.asarray(rt.super_centroids),
              "router.children": np.asarray(rt.children),
              "router.child_centroids": np.asarray(rt.child_centroids)})
    return f


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_same_state(a, b, step=""):
    """Two mutable indexes (either package) equal bit for bit: the state
    arrays, the counters and the router's trained tables."""
    for k in STATE + ("centroids",):
        np.testing.assert_array_equal(_np(getattr(a, k)), _np(getattr(b, k)),
                                      err_msg=f"{step}: {k}")
    for k in COUNTS:
        assert getattr(a, k) == getattr(b, k), (step, k)
    for k in ("super_centroids", "children", "child_centroids"):
        np.testing.assert_array_equal(_np(getattr(a.router, k)),
                                      _np(getattr(b.router, k)), err_msg=k)
    np.testing.assert_array_equal(_np(a.pq.centers), _np(b.pq.centers))


def script(m, X):
    """The mutation script both packages run: adds, hard and soft removals,
    harden, a removal that crosses the compaction threshold (one record:
    the compaction it implies is not logged), an explicit compact."""
    m.add(X[N0:N0 + 200])
    m.remove(np.arange(0, 300, 3))
    m.remove(np.arange(1, 200, 7), hard=False)
    m.harden_soft_deletes()
    m.add(X[N0 + 200:N0 + 400])
    n_dead = m.n_dead_slots
    m.remove(np.arange(400, 1200))
    assert m.n_dead_slots == 0 < n_dead      # the threshold compaction ran
    m.compact()


SCRIPT_RECORDS = [REC_ADD, REC_REMOVE, REC_REMOVE, REC_HARDEN, REC_ADD,
                  REC_REMOVE, REC_COMPACT]


@pytest.fixture(scope="module")
def data(rng):
    return rng.normal(size=(N0 + 400, D)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_base(data):
    return JaxMutableIVF.build(jax.random.PRNGKey(1), data[:N0], C,
                               spill_mode="soar", pq_subspaces=M, train_iters=4,
                               router="tree", router_kw={"n_super": 4})


def fresh_pair(jax_base):
    """(a JAX MutableIVF, its port twin on the CPU), equal bit for bit."""
    jm = JaxMutableIVF.from_index(jax_base.to_ivf_index())
    tm = convert.mutable_from_numpy(mutable_fields(jm), device="cpu")
    assert_same_state(jm, tm, "carried")
    return jm, tm


@pytest.fixture(scope="module")
def scripted(jax_base, data):
    jm, tm = fresh_pair(jax_base)
    script(jm, data)
    script(tm, data)
    assert_same_state(jm, tm, "scripted")
    return jm, tm


# ------------------------------------------------- the two packages' files
def _objects(pair, kind, jax_side):
    jm, tm = pair
    m = jm if jax_side else tm
    if kind == "MutableIVF":
        return m
    if kind == "IVFIndex":
        return m.to_ivf_index()
    return m.pack(pair_codes=False) if jax_side else m.pack()


@pytest.mark.parametrize("kind", ["MutableIVF", "IVFIndex"])
def test_snapshots_are_byte_identical_to_jax(scripted, tmp_path, kind):
    pj, pt = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_store.save_snapshot(pj, _objects(scripted, kind, True), extra={"note": 1})
    save_snapshot(pt, _objects(scripted, kind, False), extra={"note": 1})
    for name in ("arrays.bin", "manifest.json"):
        with open(os.path.join(pj, name), "rb") as a, open(os.path.join(pt, name), "rb") as b:
            assert a.read() == b.read(), name
    assert json.load(open(os.path.join(pt, "manifest.json")))["manifest"]["kind"] == kind


def _search_port(obj, kind, Q):
    if kind == "MutableIVF":
        return AnnEngine(obj, top_t=6, rerank_budget=64).search(Q, k=K)[0]
    if kind == "IVFIndex":
        return search_numpy(obj, Q, **SEARCH)[0].numpy()
    return search_jit(obj, Q, **SEARCH)[0].numpy()


def _search_jax(obj, kind, Q):
    if kind == "MutableIVF":
        return JaxAnnEngine(obj, top_t=6, rerank_budget=64).search(Q, k=K)[0]
    if kind == "IVFIndex":
        return jax_search.search_numpy(obj, Q, **SEARCH)[0]
    return np.asarray(jax_search.search_jit(obj, jax.numpy.asarray(Q), **SEARCH)[0])


def _arrays(obj, kind):
    names = {"MutableIVF": STATE + ("centroids",),
             "IVFIndex": ("centroids", "starts", "point_ids", "codes",
                          "rerank_f32", "assignments"),
             "PackedIVF": ("centroids", "part_ids", "part_codes", "sizes", "rerank")}
    return {k: _np(getattr(obj, k)) for k in names[kind]}


KINDS = ["MutableIVF", "IVFIndex", "PackedIVF"]


@pytest.mark.parametrize("kind", KINDS)
def test_jax_snapshot_opens_in_port(scripted, queries, tmp_path, kind):
    """A JAX-written snapshot (a PackedIVF with pair codes too) loads into
    the port with JAX's bits and searches as the port's own twin."""
    p = str(tmp_path / "snap")
    src = _objects(scripted, kind, True)
    if kind == "PackedIVF":
        src = scripted[0].pack(pair_codes=True)
        assert src.part_codes2 is not None
    jax_store.save_snapshot(p, src)
    got, _ = load_snapshot(p, expect_kind=kind, device="cpu")
    for k, want in _arrays(src, kind).items():
        np.testing.assert_array_equal(_np(getattr(got, k)), want, err_msg=k)
    np.testing.assert_array_equal(_search_port(got, kind, queries),
                                  _search_port(_objects(scripted, kind, False), kind, queries))


@pytest.mark.parametrize("kind", KINDS)
def test_port_snapshot_opens_in_jax(scripted, queries, tmp_path, kind):
    """A port-written snapshot loads into the JAX package with the port's
    bits and searches there as JAX's own twin."""
    p = str(tmp_path / "snap")
    src = _objects(scripted, kind, False)
    save_snapshot(p, src)
    got, _ = jax_store.load_snapshot(p, expect_kind=kind)
    for k, want in _arrays(src, kind).items():
        np.testing.assert_array_equal(_np(getattr(got, k)), want, err_msg=k)
    if kind == "PackedIVF":
        assert got.part_codes2 is None
    np.testing.assert_array_equal(_search_jax(got, kind, queries),
                                  _search_jax(_objects(scripted, kind, True), kind, queries))


def test_logs_are_byte_identical_and_each_package_replays_the_other(
        jax_base, data, tmp_path):
    """The same script with a log attached writes the same wal.log bytes;
    each package reopens the other's directory (snapshot + log) to the
    other's live state; a threshold compaction inside a remove is no
    record of its own."""
    jm, tm = fresh_pair(jax_base)
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    JaxAnnEngine(jm).save(dj)
    AnnEngine(tm).save(dt)
    je = JaxAnnEngine.open(dj, wal=True)
    te = AnnEngine.open(dt, wal=True, device="cpu")
    script(je.index, data)
    script(te.index, data)
    assert_same_state(je.index, te.index, "logged")
    with open(os.path.join(dj, "wal.log"), "rb") as a, \
            open(os.path.join(dt, "wal.log"), "rb") as b:
        assert a.read() == b.read()
    recs = list(read_records(os.path.join(dt, "wal.log")))
    assert [r[1] for r in recs] == SCRIPT_RECORDS
    assert [r[0] for r in recs] == list(range(1, len(SCRIPT_RECORDS) + 1))
    assert recs[0][3]["x"].dtype == np.float32 and recs[1][3]["ids"].dtype == np.int64
    assert recs[1][2] == {"hard": True} and recs[2][2] == {"hard": False}
    # each package replays the other's log onto the other's snapshot
    port_from_jax = AnnEngine.open(dj, device="cpu")
    jax_from_port = JaxAnnEngine.open(dt)
    assert_same_state(port_from_jax.index, je.index, "port replays JAX")
    assert_same_state(jax_from_port.index, te.index, "JAX replays port")
    for e in (je, te, port_from_jax, jax_from_port):
        e.index._wal.close()


def test_knn_memory_snapshot_is_refused_by_name(rng, tmp_path):
    """The KNNMemory kind is not ported yet: loading one names the roadmap
    item, and never passes as corrupt or as another kind."""
    from repro.serve.knn_memory import KNNMemory
    Kv = rng.normal(size=(200, 8)).astype(np.float32)
    mem = KNNMemory.build(Kv, Kv, n_partitions=4)
    p = str(tmp_path / "mem")
    mem.save(p)
    snap = os.path.join(p, "index") if os.path.isdir(os.path.join(p, "index")) else p
    with pytest.raises(NotImplementedError, match="Queue A item 7"):
        load_snapshot(snap, device="cpu")


# --------------------------------------------------- the port on its own
@pytest.fixture(scope="module")
def built(rng):
    """One shared engine: PQ + tree router + hard and soft tombstones —
    every piece of state the snapshot must carry."""
    X = rng.normal(size=(500, D)).astype(np.float32)
    eng = AnnEngine.build(torch.Generator().manual_seed(0), X, 16, pq_subspaces=4,
                          router="tree", router_kw={"n_super": 4}, device="cpu")
    eng.add(rng.normal(size=(40, D)).astype(np.float32))
    eng.remove([3, 5, 7], hard=True)
    eng.remove([11, 13], hard=False)
    return eng


def _clone(eng, tmp_path, name):
    p = str(tmp_path / name)
    eng.save(p)
    return AnnEngine.open(p, device="cpu"), p


def test_engine_snapshot_roundtrip_bitwise(built, queries, tmp_path):
    i0, s0 = built.search(queries, k=K)
    e2, _ = _clone(built, tmp_path, "eng")
    i1, s1 = e2.search(queries, k=K)
    assert np.array_equal(i0, i1) and np.array_equal(s0, s1)
    assert (e2.top_t, e2.rerank_budget, e2.bq) == (
        built.top_t, built.rerank_budget, built.bq)
    assert_same_state(e2.index, built.index)
    assert e2.index.n_soft_deleted == 2 and e2.index._wal is None


def test_ivf_snapshot_roundtrip_host_engine(built, queries, tmp_path):
    idx = built.index.to_ivf_index()
    i0, st0 = search_numpy(idx, queries, **SEARCH)
    p = str(tmp_path / "ivf")
    save_snapshot(p, idx)
    idx2, _ = load_snapshot(p, expect_kind="IVFIndex", device="cpu")
    i1, st1 = search_numpy(idx2, queries, **SEARCH)
    assert torch.equal(i0, i1)
    assert torch.equal(st0.points_read, st1.points_read)
    assert type(idx2.router) is type(idx.router)
    assert torch.equal(idx2.router.children, idx.router.children)


def test_packed_snapshot_roundtrip(built, queries, tmp_path):
    packed = built.index.pack()
    p = str(tmp_path / "packed")
    save_snapshot(p, packed)
    got, _ = load_snapshot(p, expect_kind="PackedIVF", device="cpu")
    assert torch.equal(got.extent, packed.extent)
    assert all(torch.equal(getattr(got, k), getattr(packed, k))
               for k in ("part_ids", "part_codes", "sizes", "rerank"))
    a, b = search_jit(got, queries, **SEARCH), search_jit(packed, queries, **SEARCH)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_extra_arrays_ride_the_snapshot(built, tmp_path):
    p = str(tmp_path / "x")
    built.save(p, extra={"frontend": {"max_batch": 7}},
               extra_arrays={"tenant_0": np.arange(5, dtype=np.uint8)})
    _, extra = load_snapshot(os.path.join(p, "index"), device="cpu")
    assert extra["frontend"] == {"max_batch": 7} and extra["engine"]["top_t"] == built.top_t
    got = index_store.load_extra_arrays(os.path.join(p, "index"))
    assert list(got) == ["tenant_0"] and np.array_equal(got["tenant_0"], np.arange(5))


def test_sharded_envelope_roundtrip(rng, built, tmp_path):
    shards = [built.index.to_ivf_index(), built.index]
    p = str(tmp_path / "shards")
    save_shards(p, shards, extra={"note": 1})
    loaded, extra = load_shards(p, device="cpu")
    assert extra == {"note": 1}
    assert torch.equal(loaded[0].point_ids, shards[0].point_ids)
    assert torch.equal(loaded[0].starts, shards[0].starts)
    assert_same_state(loaded[1], built.index)
    with pytest.raises(CorruptSnapshotError, match="not a shard envelope"):
        load_shards(os.path.join(p, "shard_0000"), device="cpu")


def test_loads_onto_the_card_unless_asked(built, tmp_path):
    """device=None means CUDA: without a card the load raises instead of
    landing on the CPU."""
    p = str(tmp_path / "dev")
    built.save(p)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            AnnEngine.open(p)
    assert AnnEngine.open(p, device="cpu").index.device.type == "cpu"


# ------------------------------------------------------- corruption → error
CORRUPTIONS = [
    ("arrays mid-file flip", "index/arrays.bin", lambda p: faults.flip_byte(p, 1000)),
    ("arrays tail flip", "index/arrays.bin", lambda p: faults.flip_byte(p, -1)),
    ("arrays truncated", "index/arrays.bin", lambda p: faults.truncate_tail(p, 7)),
    ("manifest flip", "index/manifest.json", lambda p: faults.flip_byte(p, -2)),
    ("manifest truncated", "index/manifest.json", lambda p: faults.truncate_tail(p, 30)),
]


@pytest.mark.parametrize("label,rel,inject", CORRUPTIONS, ids=[c[0] for c in CORRUPTIONS])
def test_corruption_raises_not_garbage(built, tmp_path, label, rel, inject):
    p = str(tmp_path / "c")
    built.save(p)
    inject(os.path.join(p, rel))
    with pytest.raises(CorruptSnapshotError):
        AnnEngine.open(p, device="cpu")


def test_missing_snapshot_is_clear(tmp_path):
    with pytest.raises(CorruptSnapshotError, match="no snapshot"):
        load_snapshot(str(tmp_path / "nope"), device="cpu")


# --------------------------------------------------------------- WAL unit
def test_wal_roundtrip_and_torn_tail(tmp_path):
    p = str(tmp_path / "wal.log")
    with MutationWAL(p) as w:
        w.append(REC_ADD, {"i": 0}, {"x": np.arange(6, dtype=np.float32)})
        w.append(REC_ADD, {"i": 1}, {"x": np.ones((2, 3), np.int32)})
        last = w.append(REC_ADD, {"i": 2})
    assert last == 3
    recs = list(read_records(p))
    assert [m["i"] for _, _, m, _ in recs] == [0, 1, 2]
    assert np.array_equal(recs[1][3]["x"], np.ones((2, 3), np.int32))
    # tear the final record: committed prefix survives, tail dropped
    faults.truncate_tail(p, 5)
    assert [m["i"] for _, _, m, _ in read_records(p)] == [0, 1]
    # reopening truncates the torn bytes and continues the sequence
    with MutationWAL(p) as w:
        assert w.last_seq == 2
        assert w.append(REC_ADD, {"i": 9}) == 3
    assert [m["i"] for _, _, m, _ in read_records(p)] == [0, 1, 9]


def test_wal_midfile_corruption_raises(tmp_path):
    p = str(tmp_path / "wal.log")
    with MutationWAL(p) as w:
        w.append(REC_ADD, {"i": 0}, {"x": np.zeros(8, np.float32)})
        w.append(REC_ADD, {"i": 1})
    faults.flip_byte(p, 30)            # inside record 0's payload
    with pytest.raises(CorruptSnapshotError):
        list(read_records(p))
    with pytest.raises(CorruptSnapshotError):
        MutationWAL(p)                 # the opener validates too


def test_wal_guards(tmp_path):
    with pytest.raises(ValueError):
        MutationWAL(str(tmp_path / "w"), fsync="sometimes")
    with MutationWAL(str(tmp_path / "w2"), fsync="never") as w:
        w.append(REC_ADD, {"i": 0})
        with pytest.raises(ValueError):
            w.rotate(0)                # records past 0 are in the log
        w.rotate(w.last_seq)
    assert os.path.getsize(str(tmp_path / "w2")) == 0
    # start_seq floors the sequence after a rotation
    with MutationWAL(str(tmp_path / "w2"), start_seq=7) as w:
        assert w.append(REC_ADD) == 8


def test_save_rotates_the_log_and_keeps_the_sequence(built, tmp_path):
    eng, p = _clone(built, tmp_path, "rot")
    eng = AnnEngine.open(p, wal=True, device="cpu")
    eng.add(np.ones((2, D), np.float32))
    eng.remove([0])
    assert eng.index.wal_seq == 2
    eng.save(p)
    assert os.path.getsize(os.path.join(p, "wal.log")) == 0
    eng.add(np.zeros((1, D), np.float32))
    assert [r[0] for r in read_records(os.path.join(p, "wal.log"))] == [3]
    eng.index._wal.close()
    again = AnnEngine.open(p, device="cpu")
    assert_same_state(again.index, eng.index)
    again.index._wal.close()


# ------------------------------------------------- in-process crash matrix
SNAPSHOT_FAULTS = [
    ("snapshot:arrays+0", "old"),
    ("snapshot:arrays+64", "old"),
    ("snapshot:arrays+4099", "old"),
    ("snapshot:manifest+0", "old"),
    ("snapshot:manifest+10", "old"),
    ("commit:between_renames", "old"),
    ("commit:before_cleanup", "new"),
]


@pytest.mark.parametrize("spec,expect", SNAPSHOT_FAULTS)
def test_snapshot_crash_matrix(built, queries, tmp_path, spec, expect):
    """Every crash point during an overwriting save reopens to a committed
    state — the previous snapshot for crashes before the swap completes,
    the new one after — bit for bit."""
    ra = built.search(queries, k=K)
    engB, p = _clone(built, tmp_path, "m")
    engB.add(np.linspace(0, 1, 3 * D, dtype=np.float32).reshape(3, D))
    rb = engB.search(queries, k=K)
    faults.install(spec)
    with pytest.raises(InjectedCrash):
        engB.save(p)
    faults.uninstall()
    back = AnnEngine.open(p, device="cpu")
    r2 = back.search(queries, k=K)
    want, state = (ra, built) if expect == "old" else (rb, engB)
    assert np.array_equal(r2[0], want[0]) and np.array_equal(r2[1], want[1])
    assert_same_state(back.index, state.index, spec)


def test_first_save_crash_leaves_no_committed_state(built, tmp_path):
    """Crash during the very first save: there is no previous snapshot to
    fall back to — open must refuse loudly, not serve a torn index."""
    p = str(tmp_path / "first")
    faults.install("snapshot:arrays+128")
    with pytest.raises(InjectedCrash):
        built.save(p)
    faults.uninstall()
    with pytest.raises(CorruptSnapshotError):
        AnnEngine.open(p, device="cpu")


WAL_FAULTS = [
    ("wal:append+0", "pre"),           # nothing of the record on disk
    ("wal:append+5", "pre"),           # torn header
    ("wal:append+23", "pre"),          # header complete less one byte
    ("wal:append+60", "pre"),          # torn payload
    ("wal:record", "post"),            # record durable, apply interrupted
]


@pytest.mark.parametrize("spec,expect", WAL_FAULTS)
def test_wal_crash_matrix(built, queries, tmp_path, spec, expect):
    """A crash anywhere inside a logged mutation recovers to exactly the
    pre-mutation state (torn record dropped) or the post-mutation state
    (record fully durable, replayed on open) — never between."""
    add = np.linspace(-1, 1, 4 * D, dtype=np.float32).reshape(4, D)
    _, p = _clone(built, tmp_path, "w")
    eng = AnnEngine.open(p, wal=True, device="cpu")
    r_pre = eng.search(queries, k=K)
    faults.install(spec)
    with pytest.raises(InjectedCrash):
        eng.add(add)
    faults.uninstall()
    eng.index._wal.close()
    eng2 = AnnEngine.open(p, device="cpu")
    r2 = eng2.search(queries, k=K)
    if expect == "pre":
        want, state = r_pre, built.index
    else:                              # replay applies the committed add
        ref, _ = _clone(built, tmp_path, "ref")
        ref.add(add)
        want, state = ref.search(queries, k=K), ref.index
    assert np.array_equal(r2[0], want[0]) and np.array_equal(r2[1], want[1])
    for k in STATE + ("n_total", "n_dead_slots", "n_soft_deleted"):
        np.testing.assert_array_equal(_np(getattr(eng2.index, k)),
                                      _np(getattr(state, k)), err_msg=k)
    assert eng2.index.wal_seq == (1 if expect == "post" else 0)
    eng2.index._wal.close()


# ------------------------------------------------- true-crash subprocesses
_CHILD = r"""
import os, sys
import numpy as np
import torch
from repro_torch import faults
from repro_torch.serve.engine import AnnEngine

d = sys.argv[1]
rng = np.random.default_rng(0)
X = rng.normal(size=(300, 8)).astype(np.float32)
Q = rng.normal(size=(6, 8)).astype(np.float32)
add = np.linspace(0, 1, 4 * 8, dtype=np.float32).reshape(4, 8)

eng = AnnEngine.build(torch.Generator().manual_seed(0), X, 8, pq_subspaces=2,
                      device="cpu")
p = os.path.join(d, "eng")
eng.save(p)
eng = AnnEngine.open(p, wal=True, device="cpu")
np.save(os.path.join(d, "q.npy"), Q)
i, s = eng.search(Q, k=4)
np.save(os.path.join(d, "pre.npy"), np.concatenate(
    [i.astype(np.float64), s.astype(np.float64)], axis=1))

stage = os.environ["CRASH_STAGE"]
faults.install()          # reads REPRO_FAULT / REPRO_FAULT_MODE=exit
if stage == "save":
    eng.add(add)          # committed through the WAL
    i, s = eng.search(Q, k=4)
    np.save(os.path.join(d, "post.npy"), np.concatenate(
        [i.astype(np.float64), s.astype(np.float64)], axis=1))
    eng.save(p)           # dies mid-commit (os._exit, no cleanup)
else:
    eng.add(add)          # dies mid-append
os._exit(0)
"""


@pytest.mark.parametrize("stage,fault,expect", [
    ("save", "commit:between_renames", "post"),
    ("mutate", "wal:append+30", "pre"),
])
def test_subprocess_crash_recovery(tmp_path, stage, fault, expect):
    """End to end with a REAL crash (os._exit: no atexit, no interpreter
    cleanup): reopen serves bit for bit the last committed state."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", CRASH_STAGE=stage,
               REPRO_FAULT=fault, REPRO_FAULT_MODE="exit")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         env.get("PYTHONPATH", "")])
    r = subprocess.run([sys.executable, "-c", _CHILD, str(tmp_path)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 42, (r.returncode, r.stdout, r.stderr)
    eng = AnnEngine.open(str(tmp_path / "eng"), device="cpu")
    Q = np.load(tmp_path / "q.npy")
    i, s = eng.search(Q, k=4)
    got = np.concatenate([i.astype(np.float64), s.astype(np.float64)], axis=1)
    want = np.load(tmp_path / f"{expect}.npy")
    assert np.array_equal(got, want)
    eng.index._wal.close()


# ------------------------------------------------------------ serve points
def _call(eng, point, queries):
    if point == "add":
        return eng.add(np.ones((1, D), np.float32))
    if point == "remove":
        return eng.remove([20, 21])
    return eng.search(queries, k=K)


@pytest.mark.parametrize("point", ["add", "remove", "search"])
def test_serve_points_fire_in_the_engine(built, queries, tmp_path, point):
    """engine:add / engine:remove / engine:search raise the injected fault
    before the call does anything; a transient window passes after its
    calls; plans installed in the JAX package do not reach the port."""
    eng, _ = _clone(built, tmp_path, "sp")
    before = {k: getattr(eng.index, k).clone() for k in STATE}
    faults.install(f"engine:{point}", mode="error")
    with pytest.raises(faults.InjectedFault):
        _call(eng, point, queries)
    assert all(torch.equal(getattr(eng.index, k), v) for k, v in before.items())
    faults.install(f"engine:{point}@1x1", mode="transient")
    with pytest.raises(faults.InjectedTransientFault) as e:
        _call(eng, point, queries)
    assert e.value.retryable
    _call(eng, point, queries)
    faults.uninstall()
    jax_faults.install(f"engine:{point}", mode="error")
    _call(eng, point, queries)
    # an empty batch of queries returns before the search point, as in JAX
    faults.install("engine:search", mode="error")
    assert eng.search(np.empty((0, D), np.float32), k=K)[0].shape == (0, K)
