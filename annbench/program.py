"""The benchmark's only door into the program under test, `repro_torch`:
its public entry points, and the index state the references follow.

The program is imported here, lazily, from `src/` at the root of the
checkout; nothing else of the benchmark imports it.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

from annbench.reference.search import IndexState, Tree

SRC = Path(__file__).resolve().parents[1] / "src"


def _path():
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))


def present() -> bool:
    return (SRC / "repro_torch").is_dir()


def api():
    """(AnnEngine, SearchParams, build_ivf_sharded, MutableIVF)."""
    _path()
    from repro_torch.core.build import build_ivf_sharded
    from repro_torch.core.mutable import MutableIVF
    from repro_torch.serve.api import SearchParams
    from repro_torch.serve.engine import AnnEngine
    return AnnEngine, SearchParams, build_ivf_sharded, MutableIVF


def build_index(cfg: dict, X: torch.Tensor, seed: int, device, timings=None):
    """One `build_ivf_sharded` call at the configuration's `index` settings,
    its random stream seeded from the run's seed."""
    _, _, build_ivf_sharded, _ = api()
    gen = torch.Generator().manual_seed(int(seed) & ((1 << 63) - 1))
    ix = dict(cfg["index"])
    c = ix.pop("n_partitions")
    return build_ivf_sharded(gen, X, c, timings=timings, device=device, **ix)


def engine_over(cfg: dict, index):
    """An `AnnEngine` at the configuration's serving settings over a built
    `IVFIndex`."""
    AnnEngine, _, _, MutableIVF = api()
    e = cfg["engine"]
    return AnnEngine(MutableIVF.from_index(index), top_t=e["top_t"],
                     rerank_budget=e["rerank_budget"], bq=e["bq"])


def index_state(engine, rows: torch.Tensor) -> IndexState:
    """The served index's codebooks, partition slots and router tables, as
    they stand, with the benchmark's own vectors by point id."""
    idx = engine.index
    tree = None
    r = idx.router
    if r is not None and hasattr(r, "super_centroids"):
        tree = Tree(r.super_centroids, r.children, r.child_centroids, int(r.t_route))
    return IndexState(idx.centroids, idx.pq.centers, idx.part_ids, idx.part_codes,
                      rows, tree)
