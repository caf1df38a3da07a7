"""Partition-probe routing (PyTorch port of `repro/core/router.py`).

- `FlatRouter`: the exact flat probe, one Q·Cᵀ product + top-t.
- `TreeRouter`: a two-level router, k-means over the centroids: score
  `t_route` super-clusters, then take the top-t among only their children
  (the `tree_route` CUDA kernel on the card), O(S·d + t_route·cmax·d) per
  query instead of O(c·d).

The route contract: `route(Q, top_t) -> (scores (nq, t'), parts (nq, t'))`,
partitions ordered by descending score and t' = min(top_t, reachable). A
starved slot (a tree router with fewer reachable children than top_t)
carries score -inf and partition 0; downstream the PQ path adds the -inf
coarse score, so its candidates never surface.

Each router also owns the clamp (`clamp`) and one step of the filtered
search's escalation (`escalated`): flat doubles top_t; tree doubles both
top_t and t_route, so escalation widens the reachable set, not only the
cut within it. `nested_steps` says whether the steps are prefixes of one
route (flat: the probe widths of every step; tree: None).
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch

from repro_torch.core.kmeans import train_kmeans
from repro_torch.kernels.tree_route import check_tables, tree_route
from repro_torch.utils import pairwise_neg_sqdist_argmin, topk_first


def clamp_top_t(top_t: int, n_partitions: int) -> int:
    """The probe-width clamp: top_t ∈ [0, c]."""
    return max(0, min(int(top_t), int(n_partitions)))


def check_query_dim(Q, d: int, what: str = "index centroids"):
    """Clear ValueError when the query dimensionality does not match.
    Q is a tensor or a numpy array (the serving edge's `validate_queries`)."""
    qd = Q.shape[-1] if Q.ndim else None
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

    @property
    def d(self) -> int:
        return int(self.centroids.shape[1])

    def clamp(self, top_t: int) -> int:
        return clamp_top_t(top_t, self.n_partitions)

    def can_escalate(self, top_t: int) -> bool:
        return top_t < self.n_partitions

    def escalated(self, top_t: int):
        """One escalation step: doubled top_t, same router."""
        return self, self.clamp(2 * top_t)

    def nested_steps(self, top_t: int) -> List[int]:
        """The probe widths of the escalation steps above top_t, in order.
        Each step's probes are the first that many of one route:
        `route(Q, w)` is `route(Q, w')` cut to w for any w ≤ w', the same
        bits, since both are one stable sort of one product."""
        widths = []
        while self.can_escalate(top_t) and self.clamp(2 * top_t) > top_t:
            top_t = self.clamp(2 * top_t)
            widths.append(top_t)
        return widths

    def probe_flops(self, top_t: int) -> int:
        """Per-query probe-stage multiply count."""
        return self.n_partitions * self.d

    def to(self, device) -> "FlatRouter":
        return FlatRouter(self.centroids.to(device))

    def route(self, Q: torch.Tensor, top_t: int):
        """(nq, d) → (scores (nq, t), parts (nq, t)), score-descending with
        ties to the lowest index, as `jax.lax.top_k` gives."""
        return topk_first(Q @ self.centroids.T, top_t)


class TreeRouter:
    """Two-level centroid router.

    super_centroids: (S, d) f32, the second-level codebook;
    children:        (S, cmax) int32 partition ids per super, -1 padded;
    child_centroids: (S, cmax, d) f32, centroid rows grouped by super
                     (zeros at padding, masked by children >= 0);
    t_route:         supers probed per query;
    n_partitions:    the partition count c, for the clamp and escalation.

    At t_route = S every child is scored and routing gives the flat probe
    set. Tables on a CUDA device are checked for the kernel once, here.
    """

    def __init__(self, super_centroids: torch.Tensor, children: torch.Tensor,
                 child_centroids: torch.Tensor, t_route: int, n_partitions: int):
        self.super_centroids = super_centroids
        self.children = children
        self.child_centroids = child_centroids
        self.t_route = int(t_route)
        self.n_partitions = int(n_partitions)
        if any(t.is_cuda for t in (super_centroids, children, child_centroids)):
            check_tables(super_centroids, child_centroids, children)

    @property
    def n_super(self) -> int:
        return int(self.super_centroids.shape[0])

    @property
    def cmax(self) -> int:
        return int(self.children.shape[1])

    @property
    def d(self) -> int:
        return int(self.super_centroids.shape[1])

    @property
    def eff_t_route(self) -> int:
        return max(1, min(self.t_route, self.n_super))

    def clamp(self, top_t: int) -> int:
        return clamp_top_t(top_t, self.n_partitions)

    def can_escalate(self, top_t: int) -> bool:
        # escalation widens the cut (top_t) or the reachable set (t_route)
        return top_t < self.n_partitions or self.eff_t_route < self.n_super

    def escalated(self, top_t: int):
        """One escalation step through the router: doubled top_t and
        doubled t_route."""
        return (self.with_t_route(min(2 * self.eff_t_route, self.n_super)),
                self.clamp(2 * top_t))

    def nested_steps(self, top_t: int) -> None:
        """None: a step widens the reachable set (t_route), so its probes
        are not a prefix of the last step's route."""
        return None

    def with_t_route(self, t_route: int) -> "TreeRouter":
        return TreeRouter(self.super_centroids, self.children,
                          self.child_centroids, t_route, self.n_partitions)

    def probe_flops(self, top_t: int) -> int:
        return self.d * (self.n_super + self.eff_t_route * self.cmax)

    def to(self, device) -> "TreeRouter":
        return TreeRouter(self.super_centroids.to(device), self.children.to(device),
                          self.child_centroids.to(device), self.t_route,
                          self.n_partitions)

    def pruned(self, live) -> "TreeRouter":
        """The router with every child whose partition holds no live slot
        set to -1, so probe slots are not spent on empty partitions (the
        refresh `MutableIVF` runs at snapshot time). `live` is a (c,) bool
        mask (tensor or array); the work runs on the tables' device and
        the trained tables stay as they are. Returns `self` when no child
        changes. A -1 may then sit inside a children row, and a super may
        keep no child at all: the route scores such slots -inf."""
        ch = self.children
        live = torch.as_tensor(live, dtype=torch.bool, device=ch.device)
        keep = (ch >= 0) & live[ch.clamp(min=0).to(torch.int64)]
        children = torch.where(keep, ch, -1)
        if torch.equal(children, ch):
            return self
        return TreeRouter(self.super_centroids, children, self.child_centroids,
                          self.t_route, self.n_partitions)

    def route(self, Q: torch.Tensor, top_t: int):
        """Two-level probe: `tree_route` gives the (nq, t_route·cmax)
        candidate scores, then the final top-t with ties to the lowest
        index, as `jax.lax.top_k` gives."""
        scores, cand = tree_route(Q, self.super_centroids, self.child_centroids,
                                  self.children, self.eff_t_route, checked=True)
        v, pos = topk_first(scores, min(top_t, scores.shape[-1]))
        parts = torch.gather(cand, -1, pos)
        # starved slots: partition 0 at -inf (the route contract)
        return v, parts.clamp(min=0)


def _group_children(C: torch.Tensor, SC: torch.Tensor,
                    assign: Optional[torch.Tensor] = None):
    """Group the c centroid rows under their nearest super centroid →
    (children (S, cmax) int32, -1 padded; child_centroids (S, cmax, d)).

    Children of a super keep ascending partition order (a stable sort of
    the exact Euclidean assignment); `assign` overrides that assignment.
    """
    if assign is None:
        assign = pairwise_neg_sqdist_argmin(C, SC)[0]
    assign = assign.to(torch.int64)
    c, d = C.shape
    S = SC.shape[0]
    counts = torch.bincount(assign, minlength=S)
    cmax = max(1, int(counts.max()))
    order = torch.sort(assign, stable=True).indices
    sp = assign[order]
    pos = torch.arange(c, device=C.device) - (torch.cumsum(counts, 0) - counts)[sp]
    children = torch.full((S, cmax), -1, dtype=torch.int32, device=C.device)
    children[sp, pos] = order.to(torch.int32)
    child_centroids = torch.zeros((S, cmax, d), dtype=C.dtype, device=C.device)
    child_centroids[sp, pos] = C[order]
    return children, child_centroids


def train_tree_router(gen: Optional[torch.Generator], centroids: torch.Tensor,
                      n_super: Optional[int] = None, t_route: Optional[int] = None,
                      iters: int = 8) -> TreeRouter:
    """Two-level router training on the centroids' device: k-means over the
    c centroids through the same Lloyd sweep as the build (the CUDA Lloyd
    kernel on the card), then the exact Euclidean child assignment and its
    grouping into the padded (S, cmax) children table.

    Defaults: n_super = round(√c), t_route = ceil(n_super / 8).
    """
    C = centroids.to(torch.float32).contiguous()
    c = C.shape[0]
    S = int(n_super) if n_super else max(1, int(round(math.sqrt(c))))
    S = min(S, c)
    if t_route is None:
        t_route = max(1, -(-S // 8))
    if gen is None:
        gen = torch.Generator().manual_seed(0)
    if S >= c:                    # degenerate: every centroid its own super
        SC = C.clone()
        children, child_centroids = _group_children(
            C, SC, torch.arange(c, device=C.device))
    else:
        SC = train_kmeans(gen, C, S, iters=iters, final_assign=False).centroids
        children, child_centroids = _group_children(C, SC)
    return TreeRouter(SC, children, child_centroids, int(t_route), c)


def as_router(spec, centroids: torch.Tensor, gen: Optional[torch.Generator] = None,
              **kw):
    """Resolve a router spec at build time: None → None (flat probe,
    nothing stored), "flat" → FlatRouter over the centroids, "tree" →
    `train_tree_router(gen, centroids, **kw)`; a router instance passes
    through (the frozen-router rebuild)."""
    if spec is None:
        return None
    if isinstance(spec, str):
        if spec == "flat":
            return FlatRouter(centroids.to(torch.float32))
        if spec == "tree":
            return train_tree_router(gen, centroids, **kw)
        raise ValueError(f"unknown router spec {spec!r}")
    return spec
