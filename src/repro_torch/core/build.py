"""Sharded SOAR index build: sample-trained codebook + streamed assignment
(PyTorch port of `repro/core/build.py`).

1. the VQ codebook trains on a `train_sample` row sample (k-means++ seeds,
   Lloyd sweeps through the CUDA Lloyd kernel on the card);
2. primary + SOAR assignments stream over `shard_size` row tiles through
   `assign_fused` (the vq and soar CUDA kernels);
3. CSR, residual PQ and rerank assembly go through `finalize_ivf`.

`codebook=` / `pq=` freeze those stages (the rebuild contract the JAX
package's mutation-equivalence tests pin). `router=` trains (or carries) a
probe router over the codebook. `anisotropic_T=` trains a score-aware
codebook (`quant/anisotropic.py`); as in the JAX package the primaries
are still the Euclidean argmin here, so anisotropy shapes only the
centroids. `init=` / `batch_size=` select k-means' flagged modes.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.ivf import IVFIndex, finalize_ivf, spill_plan
from repro_torch.core.kmeans import train_kmeans
from repro_torch.core.router import as_router
from repro_torch.kernels.soar_assign import assign_fused
from repro_torch.quant.anisotropic import anisotropic_kmeans, eta_from_threshold
from repro_torch.quant.pq import PQCodebook
from repro_torch.spans import span, timed
from repro_torch.utils import Device, as_tensor, resolve_device

DEFAULT_TRAIN_SAMPLE = 131_072
DEFAULT_SHARD = 65_536


def train_codebook(gen: torch.Generator, X: torch.Tensor, n_partitions: int, *,
                   train_sample: Optional[int] = DEFAULT_TRAIN_SAMPLE,
                   train_iters: int = 15, anisotropic_T: float = 0.0,
                   init: str = "pp", batch_size: Optional[int] = None) -> torch.Tensor:
    """Train the (to-be-frozen) VQ codebook on a row sample of X: k-means
    (init / batch_size select its flagged modes), or anisotropic VQ when
    anisotropic_T > 0 (max(4, train_iters // 3) rounds)."""
    n, d = X.shape
    if train_sample and n > train_sample:
        with span("kmeans.sample"):
            sel = torch.randperm(n, generator=gen)[:train_sample]
            Xt = X[sel.to(X.device)].contiguous()
    else:
        Xt = X
    if anisotropic_T > 0.0:
        return anisotropic_kmeans(gen, Xt, n_partitions,
                                  eta_from_threshold(anisotropic_T, d),
                                  iters=max(4, train_iters // 3))[0]
    return train_kmeans(gen, Xt, n_partitions, iters=train_iters, init=init,
                        batch_size=batch_size, final_assign=False).centroids


def assign_shards(X: torch.Tensor, C: torch.Tensor, *, spill_mode: str = "soar",
                  lam: float = 1.0, n_spills: int = 1,
                  shard_size: int = DEFAULT_SHARD) -> torch.Tensor:
    """Fused primary + spill assignment over `shard_size` row tiles of X.

    X may lie on the host; each shard moves to C's device in turn. Returns
    the (n, 1 + spills) int32 assignment matrix on C's device.
    """
    eff_lam, eff_spills = spill_plan(spill_mode, lam, n_spills)
    n = X.shape[0]
    out = torch.empty((n, 1 + eff_spills), dtype=torch.int32, device=C.device)
    for i0 in range(0, n, shard_size):
        blk = X[i0:i0 + shard_size].to(C.device)
        out[i0:i0 + blk.shape[0]] = assign_fused(blk, C, lam=eff_lam,
                                                 n_spills=eff_spills)
    return out


def build_ivf_sharded(gen: Optional[torch.Generator], X, n_partitions: int, *,
                      spill_mode: str = "soar", lam: float = 1.0,
                      n_spills: int = 1, pq_subspaces: int = 0,
                      rerank: str = "f32", train_iters: int = 15,
                      train_sample: Optional[int] = DEFAULT_TRAIN_SAMPLE,
                      shard_size: int = DEFAULT_SHARD, anisotropic_T: float = 0.0,
                      codebook=None, pq: Optional[PQCodebook] = None,
                      init: str = "pp", batch_size: Optional[int] = None,
                      timings: Optional[dict] = None,
                      device: Device = None, router=None,
                      router_kw: Optional[dict] = None) -> IVFIndex:
    """Build a SOAR-spilled IVF(-PQ) index of X (numpy array or tensor).

    gen: the build's random stream (None → seed 0); the k-means and PQ
    stages draw from two generators seeded from it. anisotropic_T, init
    and batch_size go to `train_codebook`; rerank is "f32" or "int8".
    `codebook=` (and
    optionally `pq=`) skip training and build against the given frozen
    stages. `router` is None (flat probe, nothing stored), "flat", "tree"
    (`train_tree_router(**router_kw)` over the codebook) or a router
    instance, which is kept as it is (frozen); the tree's generator is
    derived from the k-means seed without a further draw from `gen`, so
    every other array of the index is the same as with router=None.
    timings, when given, collects per-phase wall seconds (kmeans,
    spill_assign, router, csr, pq_train, encode, rerank). The build is
    the span "build" and each phase its child "build.<phase>"
    (`repro_torch.spans`). Runs on `device` (CUDA unless the caller passes
    "cpu").
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
            if codebook is None:
                C = train_codebook(gkm, X, n_partitions, train_sample=train_sample,
                                   train_iters=train_iters, anisotropic_T=anisotropic_T,
                                   init=init, batch_size=batch_size)
            else:
                C = as_tensor(codebook, dev, torch.float32).contiguous()
        with timed("build.spill_assign", timings, "spill_assign", dev):
            assignments = assign_shards(X, C, spill_mode=spill_mode, lam=lam,
                                        n_spills=n_spills, shard_size=shard_size)
        with timed("build.router", timings, "router", dev):
            grt = torch.Generator().manual_seed(seeds[0] ^ 0x52F7)
            rt = as_router(router, C, gen=grt, **(router_kw or {}))
            if rt is not None:
                rt = rt.to(dev)
        if pq is not None:
            pq = PQCodebook(as_tensor(pq.centers, dev, torch.float32))
        return finalize_ivf(gpq, X, C, assignments, pq_subspaces=pq_subspaces,
                            rerank=rerank, spill_mode=spill_mode, lam=lam, pq=pq,
                            timings=timings, router=rt)
