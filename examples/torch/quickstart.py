"""Quickstart (PyTorch port of `examples/quickstart.py`): build a SOAR
index over synthetic embeddings, query it, and see the paper's headline
effect (spilled assignments rescue hard neighbors).

    PYTHONPATH=src python examples/torch/quickstart.py [--device cuda|cpu]

Runs on the card unless `--device cpu` is given. Sizes and printed
figures are the JAX example's; the data is the port's own seeded
`glove_like` set and the build's generator is seeded 0, so the figures
are of the same kind, not the same bits.
"""
import argparse
import time

import torch

from repro_torch.core import (build_ivf, kmr_curve, points_to_recall, search_numpy,
                              true_neighbors)
from repro_torch.data.vectors import glove_like
from repro_torch.utils import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    dev = resolve_device(ap.parse_args(argv).device)
    print("== SOAR quickstart ==")
    ds = glove_like(n=50_000, d=100, nq=200, device=dev)
    print(f"dataset: {ds.name}  X={tuple(ds.X.shape)}  Q={tuple(ds.Q.shape)}")

    tn = true_neighbors(ds.X, ds.Q, k=100)

    indexes = {}
    for mode in ("none", "soar"):
        t0 = time.time()
        indexes[mode] = build_ivf(torch.Generator().manual_seed(0), ds.X, 250,
                                  spill_mode=mode, lam=1.0, pq_subspaces=25, device=dev)
        print(f"built {mode!r} index in {time.time()-t0:.1f}s "
              f"({indexes[mode].n_assignments} assignments)")

    print("\ndatapoints that must be read for a recall target (KMR, Table 2):")
    for mode, idx in indexes.items():
        cv = kmr_curve(idx, ds.Q, tn, k=100)
        pts = {t: points_to_recall(cv, t) for t in (0.85, 0.95)}
        print(f"  {mode:5s}  R@85: {pts[0.85]:8.0f}   R@95: {pts[0.95]:8.0f}")

    print("\nend-to-end search (PQ + exact rerank), top_t=12:")
    for mode, idx in indexes.items():
        t0 = time.time()
        ids, stats = search_numpy(idx, ds.Q, top_t=12, final_k=10, rerank_budget=300)
        ids = ids.cpu()             # the timed span ends on the host
        dt = (time.time() - t0) / len(ds.Q)
        rec = (ids[:, :, None] == tn.cpu()[:, None, :10]).any(-1).float().mean()
        print(f"  {mode:5s}  recall@10={rec:.3f}  {dt*1e3:.2f} ms/query  "
              f"avg pts read={stats.points_read.float().mean():.0f}")


if __name__ == "__main__":
    main()
