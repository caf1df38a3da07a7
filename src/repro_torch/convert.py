"""Carry an index built by the JAX package across to the port.

`index_from_numpy` takes the fields of a JAX `repro.core.ivf.IVFIndex` as
numpy arrays (and plain values) and returns the port's `IVFIndex`, so both
packages can search the same bits; `packed_from_numpy` does the same for a
JAX `repro.core.search.PackedIVF` (a mutable index's packed snapshot
included), and `mutable_from_numpy` for a JAX
`repro.core.mutable.MutableIVF`'s whole state, so both packages can be
mutated side by side from the same bits, and `knn_memory_from_numpy` for a
JAX `repro.serve.knn_memory.KNNMemory`, and `model_params_from_numpy` for
a JAX model's parameter tree (`repro.models.transformer.init_params`), so
both packages compute the same function. A router travels under the names of
the JAX package's snapshot codec (`repro/ckpt/index_store.py`).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.ivf import IVFIndex
from repro_torch.core.mutable import MutableIVF
from repro_torch.core.router import FlatRouter, TreeRouter
from repro_torch.core.search import PackedIVF, slot_extent
from repro_torch.models import params as prm
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer, abstract_params
from repro_torch.quant.int8 import Int8Data
from repro_torch.quant.pq import PQCodebook
from repro_torch.serve.api import DEFAULT_TOP_T
from repro_torch.serve.knn_memory import KNNMemory
from repro_torch.train.optimizer import AdamWState
from repro_torch.utils import Device, resolve_device

FIELDS = ("centroids", "starts", "point_ids", "codes", "pq.centers",
          "assignments", "n_points", "spill_mode", "lam")
PACKED_FIELDS = ("centroids", "part_ids", "part_codes", "sizes", "pq.centers")
MUTABLE_FIELDS = ("centroids", "pq.centers", "part_ids", "part_codes", "sizes",
                  "assignments", "alive", "n_total", "n_dead_slots",
                  "n_soft_deleted", "spill_mode", "lam", "n_spills",
                  "compact_threshold")


def _reader(fields: Mapping[str, object], dev: torch.device):
    def t(key, dtype):
        a = fields.get(key)
        if a is None:
            return None
        return torch.from_numpy(np.array(a)).to(device=dev, dtype=dtype)
    return t


def _router(fields: Mapping[str, object], t):
    """The router stored under `router` (None → none)."""
    meta = fields.get("router")
    if meta is None:
        return None
    if meta["type"] == "flat":
        return FlatRouter(t("router.centroids", torch.float32))
    if meta["type"] == "tree":
        return TreeRouter(t("router.super_centroids", torch.float32),
                          t("router.children", torch.int32),
                          t("router.child_centroids", torch.float32),
                          t_route=int(meta["t_route"]),
                          n_partitions=int(meta["n_partitions"]))
    raise ValueError(f"unknown router type {meta['type']!r}")


def _missing(fields: Mapping[str, object], keys) -> None:
    missing = [k for k in keys if k not in fields]
    if missing:
        raise KeyError(f"index fields missing: {missing}")


def _rerank_rows(fields: Mapping[str, object], t):
    """A packed or mutable index's rerank table: int8 codes and scales
    under rerank_int8.q / rerank_int8.scale where given (the port's int8
    index; the JAX package holds f32 rows), else the f32 rows under
    rerank."""
    if fields.get("rerank_int8.q") is not None:
        return Int8Data(t("rerank_int8.q", torch.int8), t("rerank_int8.scale", torch.float32))
    _missing(fields, ("rerank",))
    return t("rerank", torch.float32)


def index_from_numpy(fields: Mapping[str, object], device: Device = None) -> IVFIndex:
    """JAX IVFIndex fields → the port's IVFIndex on `device`.

    Keys: centroids (c, d) f32, starts (c+1,) int, point_ids (na,) int,
    codes (na, m) uint8 or None, pq.centers (m, 16, s) f32 or None,
    assignments (n, a) int, n_points, spill_mode, lam, and the rerank rows:
    rerank_f32 (n, d) f32, or rerank_int8.q (n, d) int8 with
    rerank_int8.scale (n,) f32.
    Optional: router ({"type": "tree", "t_route", "n_partitions"} with
    router.super_centroids (S, d), router.children (S, cmax),
    router.child_centroids (S, cmax, d); or {"type": "flat"} with
    router.centroids (c, d)).
    """
    _missing(fields, FIELDS)
    t = _reader(fields, resolve_device(device))
    rerank_f32 = t("rerank_f32", torch.float32)
    rerank_int8 = None
    if fields.get("rerank_int8.q") is not None:
        rerank_int8 = Int8Data(t("rerank_int8.q", torch.int8),
                               t("rerank_int8.scale", torch.float32))
    if rerank_f32 is None and rerank_int8 is None:
        raise KeyError("index fields missing: rerank_f32 or rerank_int8.q/.scale")
    centers = t("pq.centers", torch.float32)
    return IVFIndex(
        centroids=t("centroids", torch.float32),
        starts=t("starts", torch.int64),
        point_ids=t("point_ids", torch.int32),
        codes=t("codes", torch.uint8),
        pq=PQCodebook(centers) if centers is not None else None,
        rerank_int8=rerank_int8,
        rerank_f32=rerank_f32,
        assignments=t("assignments", torch.int32),
        n_points=int(fields["n_points"]),
        spill_mode=str(fields["spill_mode"]),
        lam=float(fields["lam"]),
        router=_router(fields, t))


def packed_from_numpy(fields: Mapping[str, object], device: Device = None) -> PackedIVF:
    """JAX PackedIVF fields → the port's PackedIVF on `device`.

    Keys: centroids (c, d) f32, part_ids (c, pmax) int (-1 at padding and
    at removed points), part_codes (c, pmax, m) uint8 or None, sizes (c,)
    int (live ids), pq.centers (m, 16, s) f32 or None, rerank (n, d) f32
    (or rerank_int8.q (n, d) int8 with rerank_int8.scale (n,) f32);
    optional router as in `index_from_numpy`. The extent of each partition
    (its last slot holding an id >= 0, plus one) is computed from part_ids.
    """
    _missing(fields, PACKED_FIELDS)
    t = _reader(fields, resolve_device(device))
    ids = t("part_ids", torch.int32)
    centers = t("pq.centers", torch.float32)
    return PackedIVF(
        centroids=t("centroids", torch.float32), part_ids=ids,
        part_codes=t("part_codes", torch.uint8), sizes=t("sizes", torch.int32),
        extent=slot_extent(ids), pq=PQCodebook(centers) if centers is not None else None,
        rerank=_rerank_rows(fields, t), router=_router(fields, t))


def mutable_from_numpy(fields: Mapping[str, object], device: Device = None) -> MutableIVF:
    """JAX MutableIVF state → the port's MutableIVF on `device`.

    Keys: centroids (c, d) f32, pq.centers (m, 16, s) f32 or None, part_ids
    (c, cap) int, part_codes (c, cap, m) uint8 or None, sizes (c,) int (the
    fill offset), rerank (cap_n, d) f32 (or rerank_int8.q (cap_n, d) int8
    with rerank_int8.scale (cap_n,) f32), assignments (cap_n, a) int, alive
    (cap_n,) bool, n_total, n_dead_slots, n_soft_deleted, spill_mode, lam,
    n_spills, compact_threshold; optional wal_seq (0 when absent) and router
    as in `index_from_numpy`. Capacities are kept as they are, so both
    indexes grow alike.
    """
    _missing(fields, MUTABLE_FIELDS)
    t = _reader(fields, resolve_device(device))
    centers = t("pq.centers", torch.float32)
    return MutableIVF(
        centroids=t("centroids", torch.float32),
        pq=PQCodebook(centers) if centers is not None else None,
        spill_mode=str(fields["spill_mode"]), lam=float(fields["lam"]),
        n_spills=int(fields["n_spills"]),
        part_ids=t("part_ids", torch.int32), part_codes=t("part_codes", torch.uint8),
        sizes=t("sizes", torch.int32), rerank=_rerank_rows(fields, t),
        assignments=t("assignments", torch.int32), alive=t("alive", torch.bool),
        n_total=int(fields["n_total"]), n_dead_slots=int(fields["n_dead_slots"]),
        n_soft_deleted=int(fields["n_soft_deleted"]),
        compact_threshold=float(fields["compact_threshold"]),
        router=_router(fields, t), wal_seq=int(fields.get("wal_seq", 0)))


def knn_memory_from_numpy(fields: Mapping[str, object], device: Device = None) -> KNNMemory:
    """JAX KNNMemory state → the port's KNNMemory on `device`.

    Keys: index (the MutableIVF's fields, as `mutable_from_numpy` takes
    them), values (cap_n, hd) f32, segments (cap_n,) int32 or None, engine
    ("numpy" | "jit"); optional top_t (the serving default when absent).
    The value and segment buffers keep their capacity, so both memories
    grow alike.
    """
    _missing(fields, ("index", "values", "segments", "engine"))
    index = mutable_from_numpy(fields["index"], device=device)
    t = _reader(fields, index.device)
    return KNNMemory(index=index, values=t("values", torch.float32),
                     engine=str(fields["engine"]),
                     segments=t("segments", torch.int32),
                     top_t=int(fields.get("top_t", DEFAULT_TOP_T)))


def _params_from_numpy(cfg: ModelConfig, tree, device: Device) -> dict:
    """A numpy parameter tree checked against cfg's definitions → a tree of
    f32 tensors on `device` (the values as they are)."""
    want = dict(prm.leaf_paths(abstract_params(cfg)))
    got = dict(prm.leaf_paths(tree))
    if set(want) != set(got):
        raise KeyError(f"parameter tree differs: missing "
                       f"{sorted(set(want) - set(got))}, extra {sorted(set(got) - set(want))}")
    for path, meta in want.items():
        if tuple(np.shape(got[path])) != tuple(meta.shape):
            raise ValueError(f"{path}: shape {np.shape(got[path])}, "
                             f"expected {tuple(meta.shape)}")
    dev = resolve_device(device)
    return prm.tree_map(
        lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(dev), tree)


def model_params_from_numpy(cfg: ModelConfig, tree, device: Device = None) -> Transformer:
    """A JAX model's parameter tree as nested dicts of numpy arrays
    (`jax.tree.map(np.asarray, params)`) → the port's `Transformer` on
    `device`. Every leaf must have the shape `cfg`'s definitions give; the
    values are copied as they are (the layouts are JAX's)."""
    params = _params_from_numpy(cfg, tree, device)
    return Transformer(cfg, params, device=params["final_norm"]["scale"].device)


def train_state_from_numpy(cfg: ModelConfig, params_tree, opt_state, device: Device = None):
    """A JAX training state as numpy — the parameter tree and an
    `AdamWState` (step, m, v) whose m and v are trees like it — → the
    port's (params, `repro_torch.train.optimizer.AdamWState`) on `device`,
    the step as an int32 0-d tensor."""
    step, m, v = opt_state
    params = _params_from_numpy(cfg, params_tree, device)
    dev = params["final_norm"]["scale"].device
    return params, AdamWState(torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=dev),
                              _params_from_numpy(cfg, m, dev), _params_from_numpy(cfg, v, dev))
