"""Vector-quantization training: exact k-means++ seeding + full-batch Lloyd
(PyTorch port of `repro/core/kmeans.py`, `init="pp"` path).

Each Lloyd iteration is one `lloyd_sweep` (the fused CUDA kernel on the
card). The k-means|| seeding and the mini-batch mode of the JAX package
are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels.lloyd import lloyd_sweep
from repro_torch.utils import pairwise_neg_sqdist_argmin


class KMeansResult(NamedTuple):
    centroids: torch.Tensor                # (c, d)
    assignments: Optional[torch.Tensor]    # (n,) int32 primary (None if skipped)
    distortion: torch.Tensor               # scalar mean ||x - c||²
    history: np.ndarray                    # per-iteration distortion


def kmeans_pp_init_batched(gen: torch.Generator, X: torch.Tensor,
                           c: int) -> torch.Tensor:
    """k-means++ seeding of m independent problems X (m, n, d) → (m, c, d).

    Exact D² sampling by inverse CDF: one uniform per pick, cumsum and
    searchsorted; distances update through ||x||² − 2⟨x, c_new⟩ + ||c_new||²,
    one GEMV per pick. The random draws are made up front on the host, so
    the c − 1 sequential picks never wait for the device.
    """
    m, n, d = X.shape
    dev = X.device
    first = torch.randint(0, n, (m,), generator=gen).to(dev)
    u = torch.rand((max(c - 1, 0), m), generator=gen).to(device=dev, dtype=X.dtype)
    xn = (X * X).sum(-1)                                      # (m, n)
    rows = torch.arange(m, device=dev)
    cents = torch.zeros((m, c, d), dtype=X.dtype, device=dev)

    def dist_to(v):                                           # v (m, d)
        dv = xn - 2.0 * torch.bmm(X, v[:, :, None])[..., 0] + (v * v).sum(-1)[:, None]
        return dv.clamp(min=0.0)

    nxt = X[rows, first]
    cents[:, 0] = nxt
    min_d = dist_to(nxt)
    for i in range(1, c):
        cdf = torch.cumsum(min_d, dim=-1)
        target = (u[i - 1] * cdf[:, -1])[:, None]
        idx = torch.searchsorted(cdf, target)[:, 0].clamp(max=n - 1)
        nxt = X[rows, idx]
        cents[:, i] = nxt
        min_d = torch.minimum(min_d, dist_to(nxt))
    return cents


def kmeans_pp_init(gen: torch.Generator, X: torch.Tensor, c: int) -> torch.Tensor:
    """k-means++ seeding of X (n, d) → (c, d) centroids."""
    return kmeans_pp_init_batched(gen, X[None], c)[0]


def _stopped(prev: float, d: float, tol: float) -> bool:
    return prev - d < tol * max(abs(prev), 1e-12)


def train_kmeans(gen: torch.Generator, X: torch.Tensor, c: int, iters: int = 15,
                 init_sample: int = 32_768, tol: float = 1e-5,
                 final_assign: bool = True) -> KMeansResult:
    """Full-batch k-means: k-means++ seeds on a row sample, then Lloyd
    sweeps over all of X until the distortion stops improving by `tol`.

    final_assign=False skips the trailing re-assignment pass (callers
    that assign themselves); assignments is then None.
    """
    X = X.to(torch.float32).contiguous()
    n = X.shape[0]
    if n > init_sample:
        Xi = X[torch.randperm(n, generator=gen)[:init_sample].to(X.device)]
    else:
        Xi = X
    C = kmeans_pp_init(gen, Xi, c)
    hist = []
    prev = np.inf
    dist = torch.tensor(np.inf)
    for _ in range(iters):
        C, _, dist = lloyd_sweep(X, C)
        d = float(dist)
        hist.append(d)
        if _stopped(prev, d, tol):
            break
        prev = d
    if not final_assign:
        return KMeansResult(C, None, dist, np.asarray(hist))
    assign, min_d = pairwise_neg_sqdist_argmin(X, C)
    return KMeansResult(C, assign, min_d.mean(), np.asarray(hist))
