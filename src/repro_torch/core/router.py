"""Partition-probe routing (PyTorch port of the flat half of
`repro/core/router.py`; the two-level `TreeRouter` is not ported yet).

The route contract: `route(Q, top_t) -> (scores (nq, t), parts (nq, t))`,
partitions ordered by descending score.
"""
from __future__ import annotations

import torch


def clamp_top_t(top_t: int, n_partitions: int) -> int:
    """The probe-width clamp: top_t ∈ [0, c]."""
    return max(0, min(int(top_t), int(n_partitions)))


def check_query_dim(Q: torch.Tensor, d: int, what: str = "index centroids"):
    """Clear ValueError when the query dimensionality does not match."""
    qd = Q.shape[-1] if Q.dim() else None
    if qd != d:
        raise ValueError(f"query feature dim {qd} does not match {what} dim "
                         f"{d} (Q.shape={tuple(Q.shape)})")


class FlatRouter:
    """Exact flat probe: one Q·Cᵀ product + top-t. The product is a plain
    matmul, as the JAX package leaves it to XLA outside any kernel."""

    def __init__(self, centroids: torch.Tensor):
        self.centroids = centroids

    @property
    def n_partitions(self) -> int:
        return int(self.centroids.shape[0])

    def clamp(self, top_t: int) -> int:
        return clamp_top_t(top_t, self.n_partitions)

    def route(self, Q: torch.Tensor, top_t: int):
        """(nq, d) → (scores (nq, t), parts (nq, t)), score-descending."""
        return torch.topk(Q @ self.centroids.T, top_t, dim=-1)
