"""Exact ground truth for recall (PyTorch port of
`repro/core/kmr.py::true_neighbors`; the KMR curves are not ported yet)."""
from __future__ import annotations

import torch

from repro_torch.utils import topk_inner_product


def true_neighbors(X: torch.Tensor, Q: torch.Tensor, k: int = 100,
                   chunk: int = 8192) -> torch.Tensor:
    """Ids (nq, k) int32 of the exact top-k inner products of Q against X."""
    _, ids = topk_inner_product(Q, X, k, chunk=chunk)
    return ids


def recall_at_k(ids: torch.Tensor, true_ids: torch.Tensor, k: int) -> float:
    """Mean fraction of each query's true top-k found in its first k ids."""
    hit = (ids[:, :k, None] == true_ids[:, None, :k]).any(-1)
    return float(hit.sum()) / (ids.shape[0] * k)
