"""Carry an index built by the JAX package across to the port.

`index_from_numpy` takes the fields of a JAX `repro.core.ivf.IVFIndex` as
numpy arrays (and plain values) and returns the port's `IVFIndex`, so both
packages can search the same bits. A router travels under the names of the
JAX package's snapshot codec (`repro/ckpt/index_store.py`).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.ivf import IVFIndex
from repro_torch.core.router import FlatRouter, TreeRouter
from repro_torch.quant.pq import PQCodebook
from repro_torch.utils import Device, resolve_device

FIELDS = ("centroids", "starts", "point_ids", "codes", "pq.centers",
          "rerank_f32", "assignments", "n_points", "spill_mode", "lam")


def index_from_numpy(fields: Mapping[str, object], device: Device = None) -> IVFIndex:
    """JAX IVFIndex fields → the port's IVFIndex on `device`.

    Keys: centroids (c, d) f32, starts (c+1,) int, point_ids (na,) int,
    codes (na, m) uint8 or None, pq.centers (m, 16, s) f32 or None,
    rerank_f32 (n, d) f32, assignments (n, a) int, n_points, spill_mode, lam.
    Optional: router ({"type": "tree", "t_route", "n_partitions"} with
    router.super_centroids (S, d), router.children (S, cmax),
    router.child_centroids (S, cmax, d); or {"type": "flat"} with
    router.centroids (c, d)).
    """
    missing = [k for k in FIELDS if k not in fields]
    if missing:
        raise KeyError(f"index fields missing: {missing}")
    dev = resolve_device(device)

    def t(key, dtype):
        a = fields[key]
        if a is None:
            return None
        return torch.from_numpy(np.array(a)).to(device=dev, dtype=dtype)

    centers = t("pq.centers", torch.float32)
    meta = fields.get("router")
    if meta is None:
        router = None
    elif meta["type"] == "flat":
        router = FlatRouter(t("router.centroids", torch.float32))
    elif meta["type"] == "tree":
        router = TreeRouter(t("router.super_centroids", torch.float32),
                            t("router.children", torch.int32),
                            t("router.child_centroids", torch.float32),
                            t_route=int(meta["t_route"]),
                            n_partitions=int(meta["n_partitions"]))
    else:
        raise ValueError(f"unknown router type {meta['type']!r}")
    return IVFIndex(
        centroids=t("centroids", torch.float32),
        starts=t("starts", torch.int64),
        point_ids=t("point_ids", torch.int32),
        codes=t("codes", torch.uint8),
        pq=PQCodebook(centers) if centers is not None else None,
        rerank_f32=t("rerank_f32", torch.float32),
        assignments=t("assignments", torch.int32),
        n_points=int(fields["n_points"]),
        spill_mode=str(fields["spill_mode"]),
        lam=float(fields["lam"]),
        router=router)
