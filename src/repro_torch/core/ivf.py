"""Inverted-file (IVF) index with spilled assignments: layout and assembly
(PyTorch port of `repro/core/ivf.py`).

Layout follows the paper's memory model (§3.5, Figure 5): centroids once;
per assignment (duplicated under spilling) a point id and the PQ code of
the residual to that assignment's centroid; per point the rerank row, f32
or int8 with a per-row scale. Partitions are CSR-contiguous (starts /
point_ids). Every array of an `IVFIndex` is a tensor on the index's
device.

`build_ivf` is the monolithic build: the codebook trains on all of X
(Euclidean k-means, or anisotropic VQ whose primaries are kept and
spilled on), then assignment and `finalize_ivf`. The sample-trained,
sharded build is `core/build.py::build_ivf_sharded`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.kmeans import train_kmeans
from repro_torch.core.router import as_router
from repro_torch.core.soar import soar_assign_multi
from repro_torch.kernels.soar_assign import assign_fused, soar_assign, unit_residuals
from repro_torch.quant.anisotropic import anisotropic_kmeans, eta_from_threshold
from repro_torch.quant.int8 import Int8Data, int8_quantize
from repro_torch.quant.pq import (PQ_TRAIN_SAMPLE, PQCodebook, _encode_block,
                                  _sample_rows, train_pq)
from repro_torch.spans import span, timed
from repro_torch.utils import Device, as_tensor, resolve_device

ENCODE_CHUNK = 16_384      # assignments per residual-encode step


@dataclass
class IVFIndex:
    centroids: torch.Tensor            # (c, d) f32
    starts: torch.Tensor               # (c+1,) int64 CSR partition offsets
    point_ids: torch.Tensor            # (n_assign,) int32
    codes: Optional[torch.Tensor]      # (n_assign, m) uint8 residual PQ codes
    pq: Optional[PQCodebook]           # shared residual codebook
    rerank_int8: Optional[Int8Data]    # (n, d) int8 + (n,) scales, or None
    rerank_f32: Optional[torch.Tensor]  # (n, d) f32, or None
    assignments: torch.Tensor          # (n, a) int32 — column 0 primary
    n_points: int
    spill_mode: str                    # "none" | "naive" | "soar"
    lam: float
    router: Optional[object] = None    # probe router (core/router.py); None → flat

    @property
    def n_assignments(self) -> int:
        return int(self.point_ids.shape[0])

    @property
    def n_partitions(self) -> int:
        return int(self.centroids.shape[0])

    def partition_sizes(self) -> torch.Tensor:
        return torch.diff(self.starts)

    def memory_bytes(self, rerank: str = "int8") -> dict:
        """Index bytes by the paper's model (§3.5): centroids in f32; per
        assignment a 4-byte id and 4-bit PQ codes; per point the rerank row
        (int8: d bytes and a 4-byte scale; f32: 4d bytes)."""
        c, d = self.centroids.shape
        m = self.codes.shape[1] if self.codes is not None else 0
        per_assign = 4 + m * 0.5
        rerank_bytes = {"int8": d + 4, "f32": 4 * d}[rerank] * self.n_points
        return dict(
            centroids=4 * c * d,
            assignments=per_assign * self.n_assignments,
            rerank=rerank_bytes,
            total=4 * c * d + per_assign * self.n_assignments + rerank_bytes,
        )


def _csr_from_assignments(assignments: torch.Tensor, c: int):
    """(n, a) assignment matrix → CSR (starts, point_ids, order).

    A stable sort of the flat partition ids is exactly the counting-sort
    permutation of `repro/core/ivf.py::_stable_counting_sort`.
    """
    n, a = assignments.shape
    flat = assignments.reshape(-1).to(torch.int64)
    order = torch.sort(flat, stable=True).indices
    point_ids = torch.div(order, a, rounding_mode="floor").to(torch.int32)
    starts = torch.zeros(c + 1, dtype=torch.int64, device=assignments.device)
    starts[1:] = torch.cumsum(torch.bincount(flat, minlength=c), 0)
    return starts, point_ids, order


def finalize_ivf(gen: torch.Generator, X: torch.Tensor, C: torch.Tensor,
                 assignments: torch.Tensor, *, pq_subspaces: int = 0,
                 rerank: str = "f32", spill_mode: str = "soar", lam: float = 1.0,
                 pq: Optional[PQCodebook] = None,
                 timings: Optional[dict] = None, router=None) -> IVFIndex:
    """CSR + residual PQ + rerank assembly.

    Residuals to the centroid of each assignment are gathered, subtracted
    and encoded on the device, ENCODE_CHUNK assignments at a time (the
    fused route of the JAX package). With `pq` given the codebook is frozen
    and only encoding runs; otherwise it trains on a sample of residuals.
    rerank: "f32" keeps X as the rerank rows, "int8" quantizes it
    (`quant/int8.py`). `router` is stored on the index as it is.
    """
    if rerank not in ("f32", "int8"):
        raise ValueError(f"rerank must be 'f32' or 'int8', got {rerank!r}")
    dev = X.device
    with timed("build.csr", timings, "csr", dev):
        assignments = assignments.to(torch.int32)
        starts, point_ids, order = _csr_from_assignments(assignments, C.shape[0])
    codes = None
    if pq is not None or pq_subspaces > 0:
        flat_part = assignments.reshape(-1).to(torch.int64)[order]
        pids = point_ids.to(torch.int64)
        if pq is None:
            with timed("build.pq_train", timings, "pq_train", dev):
                na = pids.shape[0]
                with span("pq.sample"):
                    if na > PQ_TRAIN_SAMPLE:   # train_pq's own sample, drawn here
                        sel = _sample_rows(gen, na, PQ_TRAIN_SAMPLE).to(dev)
                        res = X[pids[sel]] - C[flat_part[sel]]
                    else:
                        res = X[pids] - C[flat_part]
                pq = train_pq(gen, res, pq_subspaces)
        with timed("build.encode", timings, "encode", dev):
            m, _, s = pq.centers.shape
            codes = torch.empty((pids.shape[0], m), dtype=torch.uint8, device=dev)
            for i0 in range(0, pids.shape[0], ENCODE_CHUNK):
                res = (X[pids[i0:i0 + ENCODE_CHUNK]]
                       - C[flat_part[i0:i0 + ENCODE_CHUNK]])
                codes[i0:i0 + res.shape[0]] = _encode_block(
                    pq.centers, res.reshape(-1, m, s))
    with timed("build.rerank", timings, "rerank", dev):
        rerank_int8 = int8_quantize(X) if rerank == "int8" else None
    return IVFIndex(centroids=C, starts=starts, point_ids=point_ids, codes=codes,
                    pq=pq, rerank_int8=rerank_int8,
                    rerank_f32=X if rerank == "f32" else None,
                    assignments=assignments, n_points=int(X.shape[0]),
                    spill_mode=spill_mode, lam=lam, router=router)


def spill_plan(spill_mode: str, lam: float, n_spills: int):
    """Canonical (effective lam, effective spill count) per spill mode."""
    if spill_mode == "none":
        return 0.0, 0
    if spill_mode == "naive":
        return 0.0, 1
    if spill_mode == "soar":
        return lam, n_spills
    raise ValueError(spill_mode)


def build_ivf(gen: Optional[torch.Generator], X, n_partitions: int,
              spill_mode: str = "soar", lam: float = 1.0, n_spills: int = 1,
              pq_subspaces: int = 0, rerank: str = "f32", train_iters: int = 15,
              anisotropic_T: float = 0.0, init: str = "pp",
              batch_size: Optional[int] = None, timings: Optional[dict] = None,
              router=None, router_kw: Optional[dict] = None,
              device: Device = None) -> IVFIndex:
    """Monolithic build: the codebook trains on all of X (numpy array or
    tensor), then primary + spill assignment, router, and `finalize_ivf`.

    spill_mode: "none", "naive" (second-closest centroid) or "soar" (the
    paper's loss, `n_spills` spills). With anisotropic_T > 0 the codebook
    is `anisotropic_kmeans` (η from T, max(4, train_iters // 3) rounds)
    and its score-aware primaries are spilled on (one spill, or the naive
    one: the soar kernel on the unit residual to the primary; more:
    `soar_assign_multi`); otherwise `train_kmeans` (init / batch_size select its flagged modes)
    and `assign_fused`. gen: the build's random stream (None → seed 0),
    split into the k-means and PQ generators as in `build_ivf_sharded`;
    router / router_kw / timings, and the spans "build" and
    "build.<phase>", as there. Runs on `device` (CUDA unless the caller
    passes "cpu").
    """
    with span("build"):
        dev = resolve_device(device)
        if gen is None:
            gen = torch.Generator().manual_seed(0)
        seeds = torch.randint(0, 2 ** 62, (2,), generator=gen).tolist()
        gkm = torch.Generator().manual_seed(seeds[0])
        gpq = torch.Generator().manual_seed(seeds[1])
        X = as_tensor(X, dev, torch.float32).contiguous()
        with timed("build.kmeans", timings, "kmeans", dev):
            if anisotropic_T > 0.0:
                eta = eta_from_threshold(anisotropic_T, X.shape[1])
                C, primary = anisotropic_kmeans(gkm, X, n_partitions, eta,
                                                iters=max(4, train_iters // 3))
            else:
                C = train_kmeans(gkm, X, n_partitions, iters=train_iters, init=init,
                                 batch_size=batch_size, final_assign=False).centroids
                primary = None
        eff_lam, eff_spills = spill_plan(spill_mode, lam, n_spills)
        with timed("build.spill_assign", timings, "spill_assign", dev):
            if primary is None:
                assignments = assign_fused(X, C, lam=eff_lam, n_spills=eff_spills)
            elif spill_mode == "none":
                assignments = primary[:, None]
            elif spill_mode != "soar" or n_spills == 1:
                # anisotropic primaries are not the Euclidean argmin: spill on them
                sec = soar_assign(X, unit_residuals(X, C, primary), primary, C, eff_lam)[0]
                assignments = torch.stack([primary, sec], dim=1)
            else:
                assignments = soar_assign_multi(X, C, primary, lam=lam, n_spills=n_spills)
        with timed("build.router", timings, "router", dev):
            grt = torch.Generator().manual_seed(seeds[0] ^ 0x52F7)
            rt = as_router(router, C, gen=grt, **(router_kw or {}))
            if rt is not None:
                rt = rt.to(dev)
        return finalize_ivf(gpq, X, C, assignments, pq_subspaces=pq_subspaces,
                            rerank=rerank, spill_mode=spill_mode, lam=lam,
                            timings=timings, router=rt)
