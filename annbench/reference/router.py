"""Plain reference of the two-level router's tables.

The router's stated rule: S super centroids, and each of the c partition
centroids listed once, as a child of its nearest super by squared
Euclidean distance, with its centroid row copied beside it; `t_route`
supers probed a query.
"""
from __future__ import annotations

import torch

from annbench.reference.build import BLOCK, _sqdist


def child_choice(C, supers, prec: str = "f32") -> torch.Tensor:
    """The nearest super of every partition centroid → (c,) int64."""
    return torch.cat([_sqdist(C[i:i + BLOCK], supers, prec).argmin(1)
                      for i in range(0, C.shape[0], BLOCK)])


def owner_gap(C, supers, part, owner) -> float:
    """max over (partition, super) pairs of ||c_part − s_owner||² above the
    least over all supers."""
    if part.numel() == 0:
        return 0.0
    d = _sqdist(C[part], supers, "f32")
    return float((d.gather(1, owner[:, None])[:, 0] - d.min(1).values).max())


def tables_bad(C, live, supers, children, child_centroids, t_route: int,
               n_super: int, want_t_route: int) -> int:
    """Faults of the tables, counted: a child id out of range; a live
    partition listed other than once, or any listed twice; a child's
    centroid row not its partition's, bit for bit; the super count or
    t_route not the configuration's."""
    c = C.shape[0]
    ch = children.long()
    bad = int(((ch < -1) | (ch >= c)).sum())
    ok = (ch >= 0) & (ch < c)
    cnt = torch.bincount(ch[ok], minlength=c)
    bad += int((cnt > 1).sum()) + int((live & (cnt == 0)).sum())
    rows = child_centroids[ok]
    bad += int((rows != C[ch[ok]]).any(1).sum())
    bad += int(supers.shape[0] != n_super) + int(t_route != want_t_route)
    return bad


def numbers(C, live, tree, n_super: int, want_t_route: int, control: bool = False):
    """router_bad and router_gap of a router's tables (`reference.search.Tree`);
    for the control, the reference's TF32 child choice in the tables' place."""
    ch = tree.children.long()
    sup_of = torch.arange(ch.shape[0], device=ch.device)[:, None].expand_as(ch)
    ok = ch >= 0
    part, owner = ch[ok].clamp(max=C.shape[0] - 1), sup_of[ok]
    if control:
        part = torch.arange(C.shape[0], device=C.device)
        owner = child_choice(C, tree.supers, "tf32")
        bad = 0
    else:
        bad = tables_bad(C, live, tree.supers, tree.children, tree.child_centroids,
                         tree.t_route, n_super, want_t_route)
    return {"router_bad": bad, "router_gap": owner_gap(C, tree.supers, part, owner)}
