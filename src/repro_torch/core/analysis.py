"""Statistics behind the paper's analysis figures (Figs 1, 2, 4, 7, 9)
(PyTorch port of `repro/core/analysis.py`).

All functions work on (query, true-neighbour) pairs: for each query q and
each of its true top-k neighbours x, the residual r = x - C_pi(x) and the
spilled residual r' = x - C_pi'(x). Inputs are numpy arrays or tensors;
the work runs on C's device when C is a tensor, else on `device` (CUDA
unless the caller passes "cpu").
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.kmr import _ranks
from repro_torch.utils import Device, as_tensor, resolve_device


class PairStats(NamedTuple):
    """One flat (nq·k,) f32 tensor per statistic, on the inputs' device."""
    qr: torch.Tensor        # <q, r>        per (query, neighbour) pair
    qr2: torch.Tensor       # <q, r'>
    cos1: torch.Tensor      # cos(theta)  = <q,r>/(||q|| ||r||)
    cos2: torch.Tensor      # cos(theta')
    rnorm: torch.Tensor     # ||r||
    r2norm: torch.Tensor    # ||r'||
    res_cos: torch.Tensor   # <r_hat, r'_hat>  (residual-residual angle)


def _inputs(X, C, assignments, Q, true_ids, device: Device):
    dev = C.device if isinstance(C, torch.Tensor) else resolve_device(device)
    return (as_tensor(X, dev, torch.float32), as_tensor(C, dev, torch.float32),
            as_tensor(assignments, dev).long(), as_tensor(Q, dev, torch.float32),
            as_tensor(true_ids, dev).long())


def pair_stats(X, C, assignments, Q, true_ids, device: Device = None) -> PairStats:
    """assignments: (n, 2) [primary, spilled]."""
    X, C, A, Q, tid = _inputs(X, C, assignments, Q, true_ids, device)
    nbr = X[tid]                                          # (nq, k, d)
    r = nbr - C[A[:, 0][tid]]
    r2 = nbr - C[A[:, 1][tid]]
    qn = torch.linalg.vector_norm(Q, dim=-1, keepdim=True)
    qr = torch.einsum("qd,qkd->qk", Q, r)
    qr2 = torch.einsum("qd,qkd->qk", Q, r2)
    rn = torch.linalg.vector_norm(r, dim=-1).clamp(min=1e-12)
    r2n = torch.linalg.vector_norm(r2, dim=-1).clamp(min=1e-12)
    rescos = torch.einsum("qkd,qkd->qk", r, r2) / (rn * r2n)
    out = (qr, qr2, qr / (rn * qn), qr2 / (r2n * qn), rn, r2n, rescos)
    return PairStats(*[o.reshape(-1) for o in out])


def pearson(a: torch.Tensor, b: torch.Tensor) -> float:
    a = a - a.mean()
    b = b - b.mean()
    denom = torch.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / denom.clamp(min=1e-12))


def score_error_correlation(stats: PairStats) -> float:
    """rho(<q,r>, <q,r'>) over observed pairs (Figure 9 y-axis)."""
    return pearson(stats.qr, stats.qr2)


def angle_correlation(stats: PairStats) -> float:
    """rho(cos theta, cos theta') (Figures 4 / 7)."""
    return pearson(stats.cos1, stats.cos2)


def mean_qr_by_rank(X, C, assignments, Q, true_ids, n_bins: int = 20,
                    device: Device = None):
    """Figure 1: mean <q,r> bucketed by RANK(q, C_pi(x), C), over log-spaced
    rank bins → (bin centers, means) as numpy arrays."""
    X, C, A, Q, tid = _inputs(X, C, assignments, Q, true_ids, device)
    ranks = _ranks(C, A, Q, tid)[1][..., 0].reshape(-1)
    qr = pair_stats(X, C, A, Q, tid).qr
    edges = np.unique(np.geomspace(1, max(int(ranks.max()), 2), n_bins).astype(int))
    centers, means = [], []
    for lo, hi in zip(edges[:-1], edges[1:]):
        m = (ranks >= lo - 1) & (ranks < hi)
        if bool(m.any()):
            centers.append((lo + hi) / 2)
            means.append(float(qr[m].mean()))
    return np.array(centers), np.array(means)
