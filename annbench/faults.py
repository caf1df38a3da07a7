"""Faults planted in the program under test, by name: the breakages that
`correct` has to catch. The benchmark's own runs never plant one; the
tests plant each at a tiny size on the CPU, and `calibrate.py --fault`
reads one on the card at a cell's own size.

    with faults.planted("lloyd_frozen"):
        ...                      # the program runs with its Lloyd step frozen

Each fault names the number expected to catch it (`CAUGHT_BY`).
"""
from __future__ import annotations

import contextlib
import importlib

import torch

from annbench import program


def _answer_altered(real):
    def search_request(self, Q, params=None, **kw):
        r = real(self, Q, params, **kw)
        r.ids[0, 0] = (r.ids[0, 0] + 1) % 1000              # one answer altered
        return r
    return search_request


def _batch_halved(real):
    def search_request(self, Q, params=None, **kw):
        r = real(self, Q, params, **kw)
        n = r.ids.shape[0]                                   # the batch's second half left out
        r.ids[n // 2:], r.scores[n // 2:] = -1, float("-inf")
        return r
    return search_request


def _assignments(kind):
    def wrap(real):
        def assign_shards(X, C, **kw):
            A = real(X, C, **kw)
            if kind == "spill_at_primary":                   # the spill step returns the primary
                A[:, 1] = A[:, 0]
            else:                                            # half of the rows left unassigned
                A[A.shape[0] // 2:] = 0
            return A
        return assign_shards
    return wrap


def _code_altered(real):
    def finalize_ivf(*a, **kw):
        idx = real(*a, **kw)
        idx.codes[0, 0] = (idx.codes[0, 0].to(torch.int64) + 1) % 16
        return idx
    return finalize_ivf


def _frozen(real):
    """A Lloyd sweep that returns the centroids it was given."""
    def sweep(X, C, *a, **kw):
        _, counts, dist = real(X, C, *a, **kw)
        return C, counts, dist
    return sweep


def _children(kind):
    def wrap(real):
        def group_children(C, SC, assign=None):
            children, cc = real(C, SC, assign)
            children, cc = children.clone(), cc.clone()
            if kind == "router_child_dropped":               # a partition listed under no super
                children[0, 0] = -1
            elif kind == "child_centroid_altered":           # a child's centroid row not its own
                cc[0, 0] += 1e-3
            else:                                            # two children under each other's super
                j = int((children[1] >= 0).sum()) - 1
                children[0, 0], children[1, j] = children[1, j].clone(), children[0, 0].clone()
                cc[0, 0], cc[1, j] = cc[1, j].clone(), cc[0, 0].clone()
            return children, cc
        return group_children
    return wrap


# name → (module[:class] patched, attribute, wrapper of the real one, number that catches it)
FAULTS = {
    "answer_altered": ("repro_torch.serve.engine:AnnEngine", "search_request",
                       _answer_altered, "miss_share"),
    "batch_halved": ("repro_torch.serve.engine:AnnEngine", "search_request",
                     _batch_halved, "bad_ids"),
    "spill_at_primary": ("repro_torch.core.build", "assign_shards",
                         _assignments("spill_at_primary"), "slot_bad"),
    "rows_halved": ("repro_torch.core.build", "assign_shards",
                    _assignments("rows_halved"), "slot_bad"),
    "code_altered": ("repro_torch.core.build", "finalize_ivf", _code_altered, "code_gap"),
    "lloyd_frozen": ("repro_torch.core.kmeans", "lloyd_sweep", _frozen, "codebook_excess"),
    "pq_frozen": ("repro_torch.quant.pq", "lloyd_sweep_batched", _frozen, "pq_excess"),
    "router_child_dropped": ("repro_torch.core.router", "_group_children",
                             _children("router_child_dropped"), "router_bad"),
    "child_centroid_altered": ("repro_torch.core.router", "_group_children",
                               _children("child_centroid_altered"), "router_bad"),
    "router_children_swapped": ("repro_torch.core.router", "_group_children",
                                _children("router_children_swapped"), "router_gap"),
}
CAUGHT_BY = {k: v[3] for k, v in FAULTS.items()}


@contextlib.contextmanager
def planted(name: str):
    """The program with fault `name` planted, for the body of the block."""
    path, attr, wrap, _ = FAULTS[name]
    program.api()
    mod, _, cls = path.partition(":")
    target = importlib.import_module(mod)
    if cls:
        target = getattr(target, cls)
    real = getattr(target, attr)
    setattr(target, attr, wrap(real))
    try:
        yield
    finally:
        setattr(target, attr, real)
