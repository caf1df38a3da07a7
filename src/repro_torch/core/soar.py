"""SOAR: spilling with orthogonality-amplified residuals (PyTorch port of
`repro/core/soar.py`).

Theorem 3.1: for query weight |t|^lambda on the hypersphere the spilled
assignment minimizes ||r'||² + lambda·||proj_r r'||², r' = x − c'. In
matmul form, per row i and centroid j:

    loss_ij = ||c_j||² − 2⟨x_i,c_j⟩ + lambda·(⟨r̂_i,x_i⟩ − ⟨r̂_i,c_j⟩)²  (+ ||x_i||²)

These plain compositions are the paper's loss as written; the build runs
the fused kernels of `kernels/soar_assign.py`, and the tests use these as a
second oracle.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.soar_assign import unit_residuals


def soar_assign(X: torch.Tensor, C: torch.Tensor, primary: torch.Tensor,
                lam: float = 1.0, chunk: int = 8192) -> torch.Tensor:
    """Single spilled assignment per point under the SOAR loss.

    X (n, d), C (c, d), primary (n,) → (n,) int32 spills, never the primary.
    """
    rhat = unit_residuals(X, C, primary)
    cn = (C * C).sum(-1)
    out = torch.empty(X.shape[0], dtype=torch.int32, device=X.device)
    for i0 in range(0, X.shape[0], chunk):
        xb, rb = X[i0:i0 + chunk], rhat[i0:i0 + chunk]
        pb = primary[i0:i0 + chunk].to(torch.int64)
        rx = (rb * xb).sum(-1)
        loss = cn[None, :] - 2.0 * (xb @ C.T) + lam * (rx[:, None] - rb @ C.T) ** 2
        loss.scatter_(1, pb[:, None], float("inf"))
        out[i0:i0 + xb.shape[0]] = loss.argmin(-1).to(torch.int32)
    return out


def soar_assign_multi(X: torch.Tensor, C: torch.Tensor, primary: torch.Tensor,
                      lam: float = 1.0, n_spills: int = 1,
                      chunk: int = 8192) -> torch.Tensor:
    """More than one spilled assignment per point (paper §3.5.1).

    Spill k + 1 minimizes ||c||² − 2⟨x,c⟩ + λ·Σ_{j≤k} (⟨r̂_j,x⟩ − ⟨r̂_j,c⟩)²
    over the centroids no earlier column took, r̂_j the unit residual to
    column j; the penalty sums in column order. A row with no unused
    centroid gets index 0. Returns (n, 1 + n_spills) int32, column 0 the
    primary.
    """
    cn = (C * C).sum(-1)
    assigns = [primary.to(torch.int32)]
    rhats = []
    for _ in range(n_spills):
        rhats.append(unit_residuals(X, C, assigns[-1]))
        out = torch.empty(X.shape[0], dtype=torch.int32, device=X.device)
        for i0 in range(0, X.shape[0], chunk):
            xb = X[i0:i0 + chunk]
            pen = torch.zeros((xb.shape[0], C.shape[0]), dtype=X.dtype, device=X.device)
            for rh in rhats:
                rb = rh[i0:i0 + chunk]
                pen = pen + ((rb * xb).sum(-1)[:, None] - rb @ C.T) ** 2
            loss = cn[None, :] - 2.0 * (xb @ C.T) + lam * pen
            for a in assigns:
                loss.scatter_(1, a[i0:i0 + chunk].to(torch.int64)[:, None], float("inf"))
            out[i0:i0 + xb.shape[0]] = loss.argmin(-1).to(torch.int32)
        assigns.append(out)
    return torch.stack(assigns, dim=1)


def soar_loss_values(X: torch.Tensor, C: torch.Tensor, primary: torch.Tensor,
                     candidate: torch.Tensor, lam: float = 1.0) -> torch.Tensor:
    """The SOAR loss ||r'||² + λ⟨r̂, r'⟩² of a candidate spill per point,
    r' = x − c_candidate, r̂ the unit residual to the primary."""
    rhat = unit_residuals(X, C, primary)
    rp = X - C[candidate.to(torch.int64)]
    return (rp * rp).sum(-1) + lam * (rhat * rp).sum(-1) ** 2


def naive_spill_assign(X: torch.Tensor, C: torch.Tensor, primary: torch.Tensor,
                       chunk: int = 8192) -> torch.Tensor:
    """Baseline: spill to the second-closest centroid (no SOAR term)."""
    return soar_assign(X, C, primary, lam=0.0, chunk=chunk)
