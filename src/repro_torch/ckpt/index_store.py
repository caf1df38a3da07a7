"""Durable index snapshots: atomic, versioned, checksummed save and load of
the port's index objects (PyTorch port of `repro/ckpt/index_store.py`,
DESIGN.md §3.11).

The format is the JAX package's format v1, byte for byte, so a snapshot
written by either package opens in the other. One directory a snapshot::

    <path>/
      manifest.json   {"crc": <hex of the manifest body>, "manifest":
                       {format_version, kind, checksum_algo, meta,
                        arrays: [{name, dtype, shape, offset, nbytes,
                                  crc}, ...]}}
      arrays.bin      raw little-endian array bytes, 64-byte-aligned
                      offsets

Integrity: every array carries a CRC over its raw bytes, and the manifest
body carries its own CRC, so a flipped byte anywhere fails loudly with
``CorruptSnapshotError``. The checksum algorithm is recorded in the
manifest: ``crc32c`` (Castagnoli) when the optional ``crc32c`` wheel is
present, else zlib's ``crc32``.

Atomicity: writes go to ``<path>.tmp-<pid>`` and commit through the
rename-aside protocol (``atomic_replace_dir``): fsync the tmp contents,
rename any existing snapshot to ``<path>.old``, rename tmp in, delete
old. A crash at any point leaves the previous committed snapshot
(possibly under ``.old``, which ``resolve_snapshot_dir`` renames back at
load time) or the new one, never a hybrid.

Arrays are copied to the host to be written (one device-to-host copy per
array) and loaded onto `device` (CUDA unless the caller passes "cpu").
Serialized kinds: ``IVFIndex``, ``MutableIVF`` (the whole mutation state
at capacity width, so the reopened index delta-packs as the saved one
did), ``PackedIVF``, and a multi-shard envelope (``save_shards`` /
``load_shards``). Routers (flat or tree) ride every kind. The JAX
package's ``KNNMemory`` kind is not ported yet: loading one raises
``NotImplementedError``.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.ckpt import faults
from repro_torch.utils import Device

FORMAT_VERSION = 1
_ALIGN = 64

try:                                   # optional hardware CRC32C wheel
    import crc32c as _crc32c_mod

    def _crc32c(data: bytes) -> int:
        return _crc32c_mod.crc32c(data)
    _HAVE_CRC32C = True
except ImportError:
    _crc32c_mod = None
    _HAVE_CRC32C = False

_ALGOS = {"crc32": zlib.crc32}
if _HAVE_CRC32C:
    _ALGOS["crc32c"] = _crc32c
_DEFAULT_ALGO = "crc32c" if _HAVE_CRC32C else "crc32"


class CorruptSnapshotError(Exception):
    """A snapshot or WAL failed an integrity check (missing/truncated
    file, CRC mismatch, bad magic/version, shape-byte mismatch). The
    load path raises this instead of ever serving a torn index."""


def _checksum(algo: str, data) -> int:
    fn = _ALGOS.get(algo)
    if fn is None:
        raise CorruptSnapshotError(
            f"snapshot written with checksum algo {algo!r}, which is not "
            f"available here (have: {sorted(_ALGOS)})")
    return fn(bytes(data)) & 0xFFFFFFFF


# ------------------------------------------------------------------ fsync
def _fsync_dir(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_replace_dir(tmp: str, dst: str):
    """Crash-safe directory swap: rename the live snapshot aside, rename
    the (already fsynced) tmp in, then delete the old copy. Every crash
    point leaves at least one fully committed directory (possibly under
    ``.old`` — see ``resolve_snapshot_dir``). Crash points are injectable
    through repro_torch.faults."""
    old = dst + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)           # leftover from an earlier crash
    if os.path.exists(dst):
        os.rename(dst, old)
    faults.crash_point("commit:between_renames")
    os.rename(tmp, dst)
    _fsync_dir(os.path.dirname(os.path.abspath(dst)) or ".")
    faults.crash_point("commit:before_cleanup")
    if os.path.exists(old):
        shutil.rmtree(old)


def resolve_snapshot_dir(path: str) -> str:
    """Finish an interrupted ``atomic_replace_dir`` at load time: if the
    snapshot is missing but ``<path>.old`` exists, the crash hit between
    the two renames — the old directory IS the last committed state, so
    rename it back and serve it."""
    if os.path.isdir(path):
        return path
    old = path + ".old"
    if os.path.isdir(old):
        os.rename(old, path)
        return path
    return path                        # let the caller raise "missing"


# --------------------------------------------------------------- manifest
def _write_manifest(f, manifest: dict, algo: str):
    body = json.dumps(manifest, sort_keys=True)
    payload = json.dumps(
        {"crc": f"{_checksum(algo, body.encode()):08x}",
         "manifest": manifest}, sort_keys=True).encode()
    faults.write(f, payload, stream="snapshot:manifest")


def read_manifest(path: str) -> dict:
    """Load + integrity-check a snapshot manifest (arrays not touched)."""
    path = resolve_snapshot_dir(path)
    mpath = os.path.join(path, "manifest.json")
    if not os.path.exists(mpath):
        raise CorruptSnapshotError(f"no snapshot at {path} (manifest.json "
                                   f"missing)")
    try:
        with open(mpath, "rb") as f:
            outer = json.load(f)
        manifest = outer["manifest"]
        crc = outer["crc"]
    except (json.JSONDecodeError, KeyError, UnicodeDecodeError) as e:
        raise CorruptSnapshotError(
            f"unreadable snapshot manifest at {mpath}: {e}") from e
    algo = manifest.get("checksum_algo", "crc32")
    body = json.dumps(manifest, sort_keys=True)
    if f"{_checksum(algo, body.encode()):08x}" != crc:
        raise CorruptSnapshotError(f"manifest checksum mismatch at {mpath}")
    ver = manifest.get("format_version")
    if ver != FORMAT_VERSION:
        raise CorruptSnapshotError(
            f"snapshot format version {ver!r} at {path}; this build reads "
            f"version {FORMAT_VERSION}")
    return manifest


# ----------------------------------------------------------- array (de)ser
def _np_host(a) -> np.ndarray:
    """A tensor on any device (or an array) → a contiguous host array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a)


def _write_state(path: str, kind: str, meta: dict, arrays: dict,
                 algo: Optional[str] = None):
    """Write one snapshot directory atomically (manifest + arrays.bin)."""
    algo = algo or _DEFAULT_ALGO
    tmp = f"{path}.tmp-{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    entries = []
    off = 0
    with open(os.path.join(tmp, "arrays.bin"), "wb") as f:
        for name, arr in arrays.items():
            if arr is None:
                continue
            a = _np_host(arr)
            pad = (-off) % _ALIGN
            if pad:
                faults.write(f, b"\x00" * pad, stream="snapshot:arrays")
                off += pad
            raw = a.tobytes()
            entries.append({"name": name, "dtype": str(a.dtype),
                            "shape": list(a.shape), "offset": off,
                            "nbytes": len(raw),
                            "crc": f"{_checksum(algo, raw):08x}"})
            faults.write(f, raw, stream="snapshot:arrays")
            off += len(raw)
        f.flush()
        os.fsync(f.fileno())
    manifest = {"format_version": FORMAT_VERSION, "kind": kind,
                "checksum_algo": algo, "meta": meta, "arrays": entries}
    with open(os.path.join(tmp, "manifest.json"), "wb") as f:
        _write_manifest(f, manifest, algo)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    atomic_replace_dir(tmp, path)


def _read_arrays(path: str, manifest: dict,
                 only_prefix: Optional[str] = None) -> dict:
    algo = manifest["checksum_algo"]
    apath = os.path.join(path, "arrays.bin")
    if not os.path.exists(apath):
        raise CorruptSnapshotError(f"{apath} missing")
    size = os.path.getsize(apath)
    out = {}
    with open(apath, "rb") as f:
        for e in manifest["arrays"]:
            if only_prefix is not None \
                    and not e["name"].startswith(only_prefix):
                continue
            if e["offset"] + e["nbytes"] > size:
                raise CorruptSnapshotError(
                    f"{apath} truncated: array {e['name']!r} needs bytes "
                    f"[{e['offset']}, {e['offset'] + e['nbytes']}) but the "
                    f"file has {size}")
            dt = np.dtype(e["dtype"])
            want = int(np.prod(e["shape"], dtype=np.int64)) * dt.itemsize
            if want != e["nbytes"]:
                raise CorruptSnapshotError(
                    f"array {e['name']!r}: manifest shape {e['shape']} "
                    f"({want} bytes) disagrees with nbytes {e['nbytes']}")
            f.seek(e["offset"])
            raw = f.read(e["nbytes"])
            if len(raw) != e["nbytes"]:
                raise CorruptSnapshotError(
                    f"short read on array {e['name']!r}")
            if f"{_checksum(algo, raw):08x}" != e["crc"]:
                raise CorruptSnapshotError(
                    f"checksum mismatch on array {e['name']!r} — the "
                    f"snapshot at {path} is corrupt")
            out[e["name"]] = np.frombuffer(raw, dtype=dt).reshape(
                e["shape"]).copy()
    return out


# ------------------------------------------------------------ object codecs
def _router_state(router):
    """Router → (meta | None, name-prefixed arrays). The frozen trained
    tables persist; derived serving views (pruning) recompute."""
    from repro_torch.core.router import FlatRouter, TreeRouter
    if router is None:
        return None, {}
    if isinstance(router, FlatRouter):
        return ({"type": "flat"},
                {"router.centroids": router.centroids})
    if isinstance(router, TreeRouter):
        return ({"type": "tree", "t_route": router.t_route,
                 "n_partitions": router.n_partitions},
                {"router.super_centroids": router.super_centroids,
                 "router.children": router.children,
                 "router.child_centroids": router.child_centroids})
    raise TypeError(f"cannot snapshot router type {type(router).__name__}")


def _pq_state(pq):
    return {} if pq is None else {"pq.centers": pq.centers}


def _state_of(obj, extra: Optional[dict]):
    """Dispatch an index object → (kind, meta, arrays)."""
    from repro_torch.core.ivf import IVFIndex
    from repro_torch.core.mutable import MutableIVF
    from repro_torch.core.search import PackedIVF
    if isinstance(obj, MutableIVF):
        kind, meta, arrays = _mutable_state(obj)
    elif isinstance(obj, IVFIndex):
        kind, meta, arrays = _ivf_state(obj)
    elif isinstance(obj, PackedIVF):
        kind, meta, arrays = _packed_state(obj)
    else:
        raise TypeError(f"cannot snapshot object of type "
                        f"{type(obj).__name__}")
    meta["extra"] = extra or {}
    return kind, meta, arrays


def _ivf_state(idx):
    rmeta, rarr = _router_state(idx.router)
    arrays = {"centroids": idx.centroids, "starts": idx.starts,
              "point_ids": idx.point_ids, "assignments": idx.assignments}
    if idx.codes is not None:
        arrays["codes"] = idx.codes
    if idx.rerank_f32 is not None:
        arrays["rerank_f32"] = idx.rerank_f32
    if idx.rerank_int8 is not None:
        arrays["rerank_int8.q"] = idx.rerank_int8.q
        arrays["rerank_int8.scale"] = idx.rerank_int8.scale
    arrays.update(_pq_state(idx.pq))
    arrays.update(rarr)
    meta = {"n_points": int(idx.n_points), "spill_mode": idx.spill_mode,
            "lam": float(idx.lam), "router": rmeta}
    return "IVFIndex", meta, arrays


def _mutable_state(mut):
    rmeta, rarr = _router_state(mut.router)
    arrays = {"centroids": mut.centroids, "part_ids": mut.part_ids,
              "sizes": mut.sizes, "rerank": mut.rerank,
              "assignments": mut.assignments,
              "alive": mut.alive.to(torch.uint8)}
    if mut.part_codes is not None:
        arrays["part_codes"] = mut.part_codes
    arrays.update(_pq_state(mut.pq))
    arrays.update(rarr)
    meta = {"spill_mode": mut.spill_mode, "lam": float(mut.lam),
            "n_spills": int(mut.n_spills), "n_total": int(mut.n_total),
            "n_dead_slots": int(mut.n_dead_slots),
            "n_soft_deleted": int(mut.n_soft_deleted),
            "compact_threshold": float(mut.compact_threshold),
            "wal_seq": int(mut.wal_seq), "router": rmeta}
    return "MutableIVF", meta, arrays


def _packed_state(p):
    """The port's PackedIVF has no pair codes, so none are written (the
    JAX loader reads their absence as None); `extent` is derived from
    part_ids at load time."""
    rmeta, rarr = _router_state(p.router)
    arrays = {"centroids": p.centroids, "part_ids": p.part_ids,
              "sizes": p.sizes, "rerank": p.rerank}
    if p.part_codes is not None:
        arrays["part_codes"] = p.part_codes
    arrays.update(_pq_state(p.pq))
    arrays.update(rarr)
    return "PackedIVF", {"router": rmeta}, arrays


def _fields(meta: dict, arrays: dict) -> dict:
    """Manifest meta + arrays → the fields of the `convert` readers, which
    take the JAX package's objects under the names this format uses."""
    return {"codes": None, "part_codes": None, "pq.centers": None,
            **meta, **arrays}


def _ivf_from(meta, arrays, device):
    from repro_torch.convert import index_from_numpy
    return index_from_numpy(_fields(meta, arrays), device=device)


def _mutable_from(meta, arrays, device):
    from repro_torch.convert import mutable_from_numpy
    return mutable_from_numpy(_fields(meta, arrays), device=device)


def _packed_from(meta, arrays, device):
    """A JAX-written `part_codes2` (pair codes) is ignored: the port's
    search has no pair-code path."""
    from repro_torch.convert import packed_from_numpy
    return packed_from_numpy(_fields(meta, arrays), device=device)


_LOADERS = {"IVFIndex": _ivf_from, "MutableIVF": _mutable_from,
            "PackedIVF": _packed_from}


# ---------------------------------------------------------------- main API
EXTRA_PREFIX = "extra."


def save_snapshot(path: str, obj, *, extra: Optional[dict] = None,
                  extra_arrays: Optional[dict] = None,
                  algo: Optional[str] = None):
    """Atomically snapshot an index object (IVFIndex / MutableIVF /
    PackedIVF) to `path`. `extra` is a JSON-able dict stored in the
    manifest (e.g. engine serving params); `extra_arrays` is a name →
    array (or tensor) dict of caller-owned arrays that ride the snapshot
    under an ``extra.`` name prefix with the same CRC and atomicity
    guarantees and load back through `load_extra_arrays`; `algo`
    overrides the checksum algorithm (default: crc32c when available,
    else crc32)."""
    kind, meta, arrays = _state_of(obj, extra)
    for name, arr in (extra_arrays or {}).items():
        key = EXTRA_PREFIX + name
        if key in arrays:
            raise ValueError(f"duplicate extra array name {name!r}")
        arrays[key] = arr
    _write_state(path, kind, meta, arrays, algo=algo)


def load_extra_arrays(path: str) -> dict:
    """Read back the `extra_arrays` stored alongside a snapshot (CRC-
    verified, ``extra.`` prefix stripped) as numpy arrays; {} when none
    were saved."""
    path = resolve_snapshot_dir(path)
    manifest = read_manifest(path)
    raw = _read_arrays(path, manifest, only_prefix=EXTRA_PREFIX)
    return {k[len(EXTRA_PREFIX):]: v for k, v in raw.items()}


def load_snapshot(path: str, *, expect_kind: Optional[str] = None,
                  device: Device = None):
    """Load a snapshot → (object on `device`, extra). Integrity is
    verified before anything is deserialized (manifest CRC, per-array
    CRCs, shape/byte agreement, truncation) and any failure raises
    CorruptSnapshotError — a torn snapshot can never reach the search
    path. An interrupted atomic swap is finished first
    (resolve_snapshot_dir)."""
    path = resolve_snapshot_dir(path)
    manifest = read_manifest(path)
    kind = manifest["kind"]
    if kind == "KNNMemory":
        raise NotImplementedError(
            f"snapshot at {path} holds a KNNMemory, which the PyTorch port "
            f"does not load yet: ROADMAP Queue A item 7 (serve/knn_memory.py)")
    if kind not in _LOADERS:
        raise CorruptSnapshotError(f"unknown snapshot kind {kind!r}")
    if expect_kind is not None and kind != expect_kind:
        raise CorruptSnapshotError(
            f"snapshot at {path} holds a {kind}, expected {expect_kind}")
    arrays = _read_arrays(path, manifest)
    meta = manifest["meta"]
    return _LOADERS[kind](meta, arrays, device), meta.get("extra", {})


# ------------------------------------------------------------ shard envelope
def save_shards(path: str, indexes, *, extra: Optional[dict] = None):
    """Snapshot a list of per-shard indexes as one atomic envelope: each
    shard is a full snapshot under ``shard_<i>/``, plus an envelope
    manifest. The whole envelope commits with the same rename-aside
    protocol, so a crash mid-save never yields a half-written shard set."""
    indexes = list(indexes)
    tmp = f"{path}.tmp-{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    for i, idx in enumerate(indexes):
        kind, meta, arrays = _state_of(idx, None)
        _write_state(os.path.join(tmp, f"shard_{i:04d}"), kind, meta,
                     arrays)
    manifest = {"format_version": FORMAT_VERSION, "kind": "ShardEnvelope",
                "checksum_algo": _DEFAULT_ALGO,
                "meta": {"n_shards": len(indexes), "extra": extra or {}},
                "arrays": []}
    with open(os.path.join(tmp, "manifest.json"), "wb") as f:
        _write_manifest(f, manifest, _DEFAULT_ALGO)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    atomic_replace_dir(tmp, path)


def load_shards(path: str, device: Device = None):
    """Load a shard envelope → (list of per-shard indexes on `device`,
    extra). Re-stacking them into one sharded serving index is the
    distributed layer's job."""
    path = resolve_snapshot_dir(path)
    manifest = read_manifest(path)
    if manifest["kind"] != "ShardEnvelope":
        raise CorruptSnapshotError(
            f"snapshot at {path} is a {manifest['kind']!r}, not a shard "
            f"envelope")
    n = manifest["meta"]["n_shards"]
    out = []
    for i in range(n):
        sp = os.path.join(path, f"shard_{i:04d}")
        if not os.path.isdir(sp):
            raise CorruptSnapshotError(
                f"shard envelope at {path} claims {n} shards but "
                f"shard_{i:04d} is missing")
        obj, _ = load_snapshot(sp, device=device)
        out.append(obj)
    return out, manifest["meta"].get("extra", {})
