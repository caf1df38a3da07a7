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


def _unit_residuals(X: torch.Tensor, C: torch.Tensor, primary: torch.Tensor,
                    eps: float = 1e-12):
    r = X - C[primary.to(torch.int64)]
    return r, r / torch.linalg.vector_norm(r, dim=-1, keepdim=True).clamp(min=eps)


def soar_assign(X: torch.Tensor, C: torch.Tensor, primary: torch.Tensor,
                lam: float = 1.0, chunk: int = 8192) -> torch.Tensor:
    """Single spilled assignment per point under the SOAR loss.

    X (n, d), C (c, d), primary (n,) → (n,) int32 spills, never the primary.
    """
    _, rhat = _unit_residuals(X, C, primary)
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


def naive_spill_assign(X: torch.Tensor, C: torch.Tensor, primary: torch.Tensor,
                       chunk: int = 8192) -> torch.Tensor:
    """Baseline: spill to the second-closest centroid (no SOAR term)."""
    return soar_assign(X, C, primary, lam=0.0, chunk=chunk)
