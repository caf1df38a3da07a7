"""K-means recall (KMR) curves and exact ground truth (PyTorch port of
`repro/core/kmr.py`).

KMR_k(t) is the mean fraction of a query's true top-k neighbours whose
best-ranked assigned partition lies within the query's top-t partitions
(Eq. (1) of the paper). As in §5.1 the curves are reported against the
mean cumulative NUMBER OF DATAPOINTS in the top-t partitions: spilled
indexes have larger partitions, so equal-t comparisons would flatter
spilling.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.utils import as_tensor, topk_inner_product


class KMRCurve(NamedTuple):
    recall_at_t: np.ndarray        # (c,) mean recall when searching top-t parts
    points_at_t: np.ndarray        # (c,) mean cumulative datapoints read
    name: str


def true_neighbors(X: torch.Tensor, Q: torch.Tensor, k: int = 100,
                   chunk: int = 8192) -> torch.Tensor:
    """Ids (nq, k) int32 of the exact top-k inner products of Q against X."""
    _, ids = topk_inner_product(Q, X, k, chunk=chunk)
    return ids


def recall_at_k(ids: torch.Tensor, true_ids: torch.Tensor, k: int) -> float:
    """Mean fraction of each query's true top-k found in its first k ids."""
    hit = (ids[:, :k, None] == true_ids[:, None, :k]).any(-1)
    return float(hit.sum()) / (ids.shape[0] * k)


def _ranks(C: torch.Tensor, assigns: torch.Tensor, Q: torch.Tensor,
           true_ids: torch.Tensor):
    """(order (nq, c): rank → partition by descending ⟨q, c⟩, ties to the
    lower partition; ranks (nq, k, a): the rank, for the query, of each
    assignment of each of its true neighbours)."""
    order = torch.argsort(-(Q @ C.T), dim=1, stable=True)
    pos = torch.arange(C.shape[0], device=C.device).expand_as(order)
    rankpos = torch.empty_like(order).scatter_(1, order, pos)
    nbr = assigns[true_ids.long()].long()                 # (nq, k, a)
    ranks = rankpos.gather(1, nbr.reshape(nbr.shape[0], -1)).reshape(nbr.shape)
    return order, ranks


def _kmr_core(C: torch.Tensor, sizes: torch.Tensor, assigns: torch.Tensor,
              Q: torch.Tensor, true_ids: torch.Tensor, k: int):
    """assigns: (n, a) int; true_ids: (nq, k); sizes: (c,) f32.

    Returns (recall (nq, c), cum_points (nq, c)): recall[q, t-1] is the
    share of q's neighbours found within its top-t partitions, cum_points
    the datapoints those partitions hold. The best ranks are counted into
    (nq, c) with one scatter of integers, so the counts are exact."""
    nq, c = Q.shape[0], C.shape[0]
    order, ranks = _ranks(C, assigns, Q, true_ids)
    cum_points = torch.cumsum(sizes[order], dim=1)
    best = ranks.amin(dim=2)                              # (nq, k)
    hist = torch.zeros((nq, c), dtype=torch.int64, device=C.device)
    hist.scatter_add_(1, best, torch.ones_like(best))
    found = torch.cumsum(hist, dim=1)
    return found.to(torch.float32) * (1.0 / k), cum_points


def _mean0(x: torch.Tensor) -> np.ndarray:
    """Column means as XLA computes `x.mean(0)` (the sum times the float32
    reciprocal of the count, as for `found / k` above), on the host."""
    return (x.sum(0) * (1.0 / x.shape[0])).cpu().numpy()


def kmr_curve(index, Q, true_ids, k: int = 100, name: str = "") -> KMRCurve:
    """The index's KMR curve over queries Q (array or tensor) with true
    neighbours `true_ids` (nq, k), computed on the index's device."""
    dev = index.centroids.device
    recall, pts = _kmr_core(
        index.centroids.to(torch.float32),
        index.partition_sizes().to(torch.float32), index.assignments,
        as_tensor(Q, dev, torch.float32), as_tensor(true_ids, dev), k)
    return KMRCurve(_mean0(recall), _mean0(pts), name or index.spill_mode)


def points_to_recall(curve: KMRCurve, target: float) -> float:
    """Mean datapoints that must be read to reach `target` mean recall
    (linear interpolation between adjacent t; inf if unreachable)."""
    r, p = curve.recall_at_t, curve.points_at_t
    idx = np.searchsorted(r, target)
    if idx >= len(r):
        return float("inf")
    if idx == 0 or r[idx] == target:
        return float(p[idx])
    r0, r1, p0, p1 = r[idx - 1], r[idx], p[idx - 1], p[idx]
    if r1 <= r0:
        return float(p[idx])
    w = (target - r0) / (r1 - r0)
    return float(p0 + w * (p1 - p0))


def rank_statistics(index, Q, true_ids):
    """Per (query, neighbour): the rank of the neighbour's primary centroid
    and of its spilled centroid (Figure 8's data), as (nq, k) int64 tensors
    on the index's device. Needs a spilled index (a >= 2)."""
    dev = index.centroids.device
    _, ranks = _ranks(index.centroids.to(torch.float32),
                      as_tensor(index.assignments, dev),
                      as_tensor(Q, dev, torch.float32), as_tensor(true_ids, dev))
    return ranks[..., 0], ranks[..., 1]
