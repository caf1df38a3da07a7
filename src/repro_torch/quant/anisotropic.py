"""Anisotropic (score-aware) quantization loss, ScaNN (Guo et al.)
(PyTorch port of `repro/quant/anisotropic.py`).

Residual error parallel to the datapoint costs more than orthogonal error,
because parallel error perturbs large inner products most:

    loss(x, c) = ||x − c||² + (η − 1)·⟨x̂, x − c⟩²,   η = (d − 1)T² / (1 − T²)

for the weight I(t ≥ T). No Pallas kernel computes any of it in the JAX
package, so everything here is plain torch at f32 (TF32 off). The
centroid update solves, per centroid j, the normal equations
A_j c_j = b_j with A_j = n_j·I + (η − 1)·Σ x̂x̂ᵀ and b_j = η·Σ x over its
rows. The sums run over the rows grouped by centroid (a stable sort), as
batched products in a fixed order with no atomics, so the codebook is
the same on every run on the card too.
"""
from __future__ import annotations

import torch

from repro_torch.spans import span

ASSIGN_CHUNK = 8192
# elements of one gathered (centroids, rows, d) block of the update
ACCUM_ELEMS = 1 << 24


def eta_from_threshold(T: float, d: int) -> float:
    """η = h_par / h_perp for the threshold T in dimension d."""
    return float((d - 1) * T * T / max(1.0 - T * T, 1e-9))


def anisotropic_assign(X: torch.Tensor, C: torch.Tensor, eta: float,
                       chunk: int = ASSIGN_CHUNK) -> torch.Tensor:
    """argmin_j ||c_j||² − 2⟨x,c_j⟩ + (η − 1)(⟨x̂,x⟩ − ⟨x̂,c_j⟩)², first index
    on ties: the SOAR loss's two products with r̂ → x̂. X (n, d), C (c, d)
    → (n,) int32."""
    xhat = X / torch.linalg.vector_norm(X, dim=-1, keepdim=True).clamp(min=1e-12)
    cn = (C * C).sum(-1)
    out = torch.empty(X.shape[0], dtype=torch.int32, device=X.device)
    for i0 in range(0, X.shape[0], chunk):
        xb, hb = X[i0:i0 + chunk], xhat[i0:i0 + chunk]
        hx = (hb * xb).sum(-1)
        loss = cn[None, :] - 2.0 * (xb @ C.T) + (eta - 1.0) * (hx[:, None] - hb @ C.T) ** 2
        out[i0:i0 + xb.shape[0]] = loss.argmin(-1).to(torch.int32)
    return out


def normal_equations(X: torch.Tensor, assign: torch.Tensor, eta: float, c: int,
                     max_elems: int = ACCUM_ELEMS):
    """(A (c, d, d), b (c, d), counts (c,)) of the anisotropic update.

    Rows are grouped by centroid with a stable sort and gathered into
    (centroids, rows, d) blocks of at most `max_elems` elements, zero at
    padding, so Σ x̂x̂ᵀ is one batched product a block and Σ x one sum.
    """
    n, d = X.shape
    dev = X.device
    assign = assign.to(torch.int64)
    order = torch.sort(assign, stable=True).indices
    counts = torch.bincount(assign, minlength=c)
    starts = torch.cumsum(counts, 0) - counts
    width = int(counts.max()) if n else 0
    xn2 = (X * X).sum(-1).clamp(min=1e-12)
    H = X / xn2.sqrt()[:, None]                         # x̂
    S = torch.zeros((c, d, d), dtype=X.dtype, device=dev)
    b = torch.zeros((c, d), dtype=X.dtype, device=dev)
    w = max(1, min(width, max_elems // max(d, 1)))
    cb = max(1, max_elems // (w * max(d, 1)))
    for j0 in range(0, c, cb):
        j1 = min(j0 + cb, c)
        for r0 in range(0, width, w):
            rank = torch.arange(r0, min(r0 + w, width), device=dev)
            keep = rank[None, :] < counts[j0:j1, None]                # (cb, w)
            rows = order[(starts[j0:j1, None] + rank[None, :]).clamp(max=n - 1)]
            keep = keep[..., None].to(X.dtype)
            Hg = H[rows] * keep
            S[j0:j1] += torch.bmm(Hg.transpose(1, 2), Hg)
            b[j0:j1] += (X[rows] * keep).sum(1)
    eye = torch.eye(d, dtype=X.dtype, device=dev)
    A = counts.to(X.dtype)[:, None, None] * eye + (eta - 1.0) * S
    return A, eta * b, counts


def _anisotropic_update(X: torch.Tensor, C: torch.Tensor, assign: torch.Tensor,
                        eta: float) -> torch.Tensor:
    """One centroid update: solve every (A_j + 1e-6·I) c_j = b_j in one
    batched `torch.linalg.solve`; empty clusters keep their centroid."""
    A, b, counts = normal_equations(X, assign, eta, C.shape[0])
    eye = torch.eye(X.shape[1], dtype=X.dtype, device=X.device)
    new = torch.linalg.solve(A + 1e-6 * eye, b[..., None])[..., 0]
    return torch.where(counts[:, None] > 0, new, C)


def anisotropic_kmeans(gen: torch.Generator, X: torch.Tensor, c: int, eta: float,
                       iters: int = 10, chunk: int = ASSIGN_CHUNK):
    """Anisotropic-loss VQ: Euclidean k-means (3 Lloyd sweeps) as the
    start, then `iters` rounds of score-aware assignment and the exact
    per-centroid solve. Returns (C (c, d), assign (n,) int32 under the
    final C). Each assignment is the span "anisotropic.assign", each
    solve "anisotropic.update"."""
    from repro_torch.core.kmeans import train_kmeans
    X = X.to(torch.float32).contiguous()
    C = train_kmeans(gen, X, c, iters=3, final_assign=False).centroids
    for _ in range(iters):
        with span("anisotropic.assign"):
            a = anisotropic_assign(X, C, eta, chunk)
        with span("anisotropic.update"):
            C = _anisotropic_update(X, C, a, eta)
    with span("anisotropic.assign"):
        return C, anisotropic_assign(X, C, eta, chunk)


def anisotropic_loss_values(X: torch.Tensor, C: torch.Tensor, assign: torch.Tensor,
                            eta: float) -> torch.Tensor:
    """Per-point anisotropic loss of the assignment (n,)."""
    r = X - C[assign.to(torch.int64)]
    xn = torch.linalg.vector_norm(X, dim=-1).clamp(min=1e-12)
    rpar = (r * X).sum(-1) / xn
    return (r * r).sum(-1) + (eta - 1.0) * rpar ** 2
