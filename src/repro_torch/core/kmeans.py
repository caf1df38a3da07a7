"""Vector-quantization training (PyTorch port of `repro/core/kmeans.py`).

Seeding: exact k-means++ (`init="pp"`, the default) or k-means||-style
over-sampling (`init="parallel"`: a few Gumbel top-l rounds of D²
candidates, Voronoi weights, weighted k-means++ and weighted Lloyd on the
candidates). Training: full-batch Lloyd (the default), or mini-batch
Lloyd (`batch_size=`, Sculley's per-centroid running-count rates); either
may renormalize the centroids after every sweep (`spherical=`). Every
sweep is one `lloyd_sweep` (the fused CUDA kernel on the card), and
k-means++'s picks one `kmeans_pp` launch (its seeding kernel). The
unfused `lloyd_step` and the Euclidean assignments are kept as the JAX
package keeps them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import spans
from repro_torch.kernels.kmeans_pp import kmeans_pp
from repro_torch.kernels.lloyd import lloyd_sweep
from repro_torch.kernels.ref import d2_draw as _d2_draw
from repro_torch.spans import span
from repro_torch.utils import pairwise_neg_sqdist_argmin, topk_first


class KMeansResult(NamedTuple):
    centroids: torch.Tensor                # (c, d)
    assignments: Optional[torch.Tensor]    # (n,) int32 primary (None if skipped)
    distortion: torch.Tensor               # scalar mean ||x - c||²
    history: np.ndarray                    # per-iteration distortion


def kmeans_pp_init_batched(gen: torch.Generator, X: torch.Tensor,
                           c: int) -> torch.Tensor:
    """k-means++ seeding of m independent problems X (m, n, d) → (m, c, d).

    Exact D² sampling by inverse CDF: one uniform per pick and an exact
    integer CDF (`_d2_draw`). The random draws are made up front on the
    host; the c − 1 sequential picks run in one launch of the seeding
    kernel on the card (`kernels/kmeans_pp.py`), in the plain loop on the
    CPU. Counts `picks` ((c − 1)·m) into the innermost recording span
    ("kmeans.seed", "pq.seed"); the kernel counts `fused_picks`.
    """
    m, n, _ = X.shape
    dev = X.device
    first = torch.randint(0, n, (m,), generator=gen).to(dev)
    u = torch.rand((max(c - 1, 0), m), generator=gen).to(device=dev, dtype=X.dtype)
    spans.count(picks=u.numel())
    return kmeans_pp(X.contiguous(), first, u)


def kmeans_pp_init(gen: torch.Generator, X: torch.Tensor, c: int) -> torch.Tensor:
    """k-means++ seeding of X (n, d) → (c, d) centroids."""
    return kmeans_pp_init_batched(gen, X[None], c)[0]


def kmeans_parallel_init(gen: torch.Generator, X: torch.Tensor, c: int, l: int,
                         rounds: int = 4, finish_iters: int = 6,
                         chunk: int = 8192) -> torch.Tensor:
    """k-means||-style over-sampling seeds of X (n, d) → (c, d).

    `rounds` × l candidates drawn D²-proportionally without replacement
    (Gumbel top-l over log D²), weighted by their Voronoi counts over X,
    then reduced to c seeds by weighted k-means++ (the heaviest candidate
    first) and `finish_iters` weighted Lloyd steps on the candidates only.
    The draws are made on the host, from `gen`.
    """
    n, d = X.shape
    dev = X.device

    def sqdist_to(P):                        # min_j ||x − p_j||² per row, ≥ 0
        return pairwise_neg_sqdist_argmin(X, P, chunk=chunk)[1].clamp(min=0.0)

    first = int(torch.randint(0, n, (1,), generator=gen))
    cands = [X[first:first + 1]]
    min_d = sqdist_to(cands[0])
    for _ in range(rounds):
        gumbel = -torch.empty(n).exponential_(generator=gen).clamp(min=1e-30).log()
        key = min_d.clamp(min=1e-30).log() + gumbel.to(device=dev, dtype=X.dtype)
        newc = X[torch.topk(key, l).indices]
        cands.append(newc)
        min_d = torch.minimum(min_d, sqdist_to(newc))
    P = torch.cat(cands)                                      # (1 + rounds·l, d)
    owner = pairwise_neg_sqdist_argmin(X, P, chunk=chunk)[0]
    w = torch.bincount(owner.to(torch.int64), minlength=P.shape[0]).to(X.dtype)

    # weighted k-means++ over the candidates
    u = torch.rand(max(c - 1, 0), generator=gen).to(device=dev, dtype=X.dtype)
    i0 = int(torch.argmax(w))
    seeds = torch.zeros((c, d), dtype=X.dtype, device=dev)
    seeds[0] = P[i0]
    dmin = ((P - P[i0]) ** 2).sum(-1)
    for i in range(1, c):
        idx = _d2_draw((dmin.clamp(min=0.0) * w)[None], u[i - 1:i])[0]
        seeds[i] = P[idx]
        dmin = torch.minimum(dmin, ((P - P[idx]) ** 2).sum(-1))

    # weighted Lloyd on the candidates; the weighted sums are one-hot
    # products, a fixed order with no atomics
    for _ in range(finish_iters):
        a = ((seeds * seeds).sum(-1)[None, :] - 2.0 * (P @ seeds.T)).argmin(-1)
        onehot = torch.nn.functional.one_hot(a, c).to(X.dtype).T * w[None, :]
        cw = onehot.sum(-1)
        seeds = torch.where(cw[:, None] > 0, (onehot @ P) / cw.clamp(min=1.0)[:, None],
                            seeds)
    return seeds


def lloyd_step(X: torch.Tensor, C: torch.Tensor, chunk: int = 16384):
    """One unfused Lloyd iteration: assign, then the mean update (two
    passes, the (n,) assignment materialized) → (new_C, assign, mean
    distortion). The reference the fused sweep is held against; empty
    clusters keep their old centroid. Its sums use `index_add_`, whose
    float order is not fixed on the card."""
    assign, min_d = pairwise_neg_sqdist_argmin(X, C, chunk=chunk)
    a = assign.to(torch.int64)
    sums = torch.zeros_like(C).index_add_(0, a, X)
    counts = torch.zeros(C.shape[0], dtype=X.dtype, device=X.device).index_add_(
        0, a, torch.ones_like(min_d))
    new_C = torch.where(counts[:, None] > 0, sums / counts.clamp(min=1.0)[:, None], C)
    return new_C, assign, min_d.mean()


def _minibatch_step(gen: torch.Generator, X: torch.Tensor, C: torch.Tensor,
                    v: torch.Tensor, batch_size: int):
    """One mini-batch sweep (rows drawn with replacement) folded into C with
    per-centroid running-count rates (Sculley) → (C, v, batch distortion)."""
    sel = torch.randint(0, X.shape[0], (batch_size,), generator=gen).to(X.device)
    bc, counts, dist = lloyd_sweep(X[sel].contiguous(), C)
    v = v + counts
    eta = counts / v.clamp(min=1.0)
    C = torch.where(counts[:, None] > 0,
                    C * (1.0 - eta[:, None]) + bc * eta[:, None], C)
    return C, v, dist


def _stopped(prev: float, d: float, tol: float) -> bool:
    return prev - d < tol * max(abs(prev), 1e-12)


def _normalized(C: torch.Tensor) -> torch.Tensor:
    return C / torch.linalg.vector_norm(C, dim=-1, keepdim=True).clamp(min=1e-12)


def train_kmeans(gen: torch.Generator, X: torch.Tensor, c: int, iters: int = 15,
                 init_sample: int = 32_768, tol: float = 1e-5,
                 final_assign: bool = True, spherical: bool = False,
                 init: str = "pp", init_rounds: int = 4,
                 init_oversample: float = 2.0,
                 batch_size: Optional[int] = None) -> KMeansResult:
    """k-means over X: seeds on a row sample, then Lloyd sweeps.

    init: "pp" (exact k-means++) or "parallel" (k-means|| over-sampling,
    init_rounds rounds of min(init_oversample·c, sample) candidates).
    batch_size: None runs full-batch sweeps over all of X until the
    distortion stops improving by `tol`; a size runs `iters` mini-batch
    sweeps (no early stop). spherical renormalizes the centroids after
    each sweep. final_assign=False skips the trailing re-assignment pass
    (callers that assign themselves); assignments is then None and the
    distortion is the last sweep's. The row sample, the seeding and the
    sweeps are the spans "kmeans.sample", "kmeans.seed" and "kmeans.lloyd"
    (`repro_torch.spans`).
    """
    X = X.to(torch.float32).contiguous()
    n = X.shape[0]
    if n > init_sample:
        with span("kmeans.sample"):
            Xi = X[torch.randperm(n, generator=gen)[:init_sample].to(X.device)]
    else:
        Xi = X
    with span("kmeans.seed"):
        if init == "pp":
            C = kmeans_pp_init(gen, Xi, c)
        elif init == "parallel":
            C = kmeans_parallel_init(gen, Xi, c,
                                     l=min(int(init_oversample * c), Xi.shape[0]),
                                     rounds=init_rounds)
        else:
            raise ValueError(f"unknown init {init!r}")
    hist = []
    dist = torch.tensor(np.inf)
    with span("kmeans.lloyd"):
        if batch_size is not None:
            v = torch.zeros(c, dtype=X.dtype, device=X.device)
            for _ in range(iters):
                C, v, dist = _minibatch_step(gen, X, C, v, batch_size)
                if spherical:
                    C = _normalized(C)
                hist.append(float(dist))
        else:
            prev = np.inf
            for _ in range(iters):
                C, _, dist = lloyd_sweep(X, C)
                if spherical:
                    C = _normalized(C)
                d = float(dist)
                hist.append(d)
                if _stopped(prev, d, tol):
                    break
                prev = d
    if not final_assign:
        return KMeansResult(C, None, dist, np.asarray(hist))
    assign, min_d = pairwise_neg_sqdist_argmin(X, C)
    return KMeansResult(C, assign, min_d.mean(), np.asarray(hist))


def assign_euclidean(X: torch.Tensor, C: torch.Tensor, chunk: int = 16384) -> torch.Tensor:
    """Primary VQ assignment: nearest centroid by squared L2 → (n,) int32."""
    return pairwise_neg_sqdist_argmin(X, C, chunk=chunk)[0]


def assign_euclidean_topk(X: torch.Tensor, C: torch.Tensor, k: int,
                          chunk: int = 16384) -> torch.Tensor:
    """The k nearest centroids per point, nearest first, ties to the lowest
    index (`lax.top_k`'s order) → (n, k) int32."""
    cn = (C * C).sum(-1)
    out = torch.empty((X.shape[0], k), dtype=torch.int32, device=X.device)
    for i0 in range(0, X.shape[0], chunk):
        xb = X[i0:i0 + chunk]
        out[i0:i0 + xb.shape[0]] = topk_first(-(cn[None, :] - 2.0 * (xb @ C.T)), k)[1]
    return out
