"""SOAR-kNN attention memory (PyTorch port of
`examples/knn_memory_decode.py`, memorizing-transformer-style serving).

Builds a long synthetic KV history for one attention head, indexes the
keys with SOAR, and compares retrieval-based attention against exact
top-k attention (see serve/knn_memory.py and DESIGN.md §5).

    PYTHONPATH=src python examples/torch/knn_memory_decode.py [--device cuda|cpu]

Runs on the card unless `--device cpu` is given; sizes and printed
figures are the JAX example's.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.data.vectors import make_manifold
from repro_torch.serve.knn_memory import KNNMemory, exact_topk_attention
from repro_torch.utils import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    dev = resolve_device(ap.parse_args(argv).device)
    hd, n_ctx, nq = 64, 100_000, 128
    # keys near a low-dim manifold (realistic attention keys are structured)
    ds = make_manifold(0, n=n_ctx, d=hd, nq=nq, intrinsic_dim=10, device=dev)
    keys = ds.X
    values = torch.randn((n_ctx, hd), generator=torch.Generator().manual_seed(1)).numpy()
    queries = ds.Q.cpu().numpy()

    exact_out, exact_ids = exact_topk_attention(queries, keys, values, k=32)

    for mode in ("none", "soar"):
        t0 = time.time()
        mem = KNNMemory.build(keys, values, n_partitions=256, lam=1.0,
                              spill_mode=mode, device=dev)
        build_s = time.time() - t0
        out, ids = mem.attend(queries, k=32, top_t=8)
        key_recall = (ids[:, :, None] == exact_ids[:, None, :]).any(-1).mean()
        err = np.linalg.norm(out - exact_out, axis=1)
        base = np.linalg.norm(exact_out, axis=1)
        print(f"  {mode:5s} build {build_s:5.1f}s  key-recall@32={key_recall:.3f}  "
              f"attn-out rel err={np.mean(err/base):.4f}")


if __name__ == "__main__":
    main()
