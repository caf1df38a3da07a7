"""Distributed SOAR serving demo (PyTorch port of `examples/ann_serving.py`):
shard a vector database 8 ways, search it with the shard-parallel engine,
compare spill modes.

    PYTHONPATH=src python examples/torch/ann_serving.py [--device cuda|cpu]

JAX shards over a mesh of 8 virtual CPU devices under `set_mesh`. Here
the 8 shards are placed with `devices=[...]`: shard s is searched on
devices[s], the visible cards taken in turn (all 8 on one card when
there is one), or the CPU with `--device cpu`; the merge runs on the
first. Sizes and printed figures are the JAX example's.
"""
import argparse
import time

import torch

from repro_torch.core import true_neighbors
from repro_torch.core.distributed import build_sharded_ivf, make_distributed_search
from repro_torch.data.vectors import make_manifold
from repro_torch.utils import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    dev = resolve_device(ap.parse_args(argv).device)
    n_shards = 8
    devices = ([torch.device("cuda", s % torch.cuda.device_count())
                for s in range(n_shards)] if dev.type == "cuda" else [dev] * n_shards)
    n, d, nq = 64_000, 64, 256
    ds = make_manifold(0, n=n, d=d, nq=nq, intrinsic_dim=10, device=devices[0])
    tn = true_neighbors(ds.X, ds.Q, k=10).cpu()
    print(f"database {tuple(ds.X.shape)} sharded over {n_shards} devices "
          f"({', '.join(sorted({str(x) for x in devices}))})")

    for mode in ("none", "soar"):
        t0 = time.time()
        sharded = build_sharded_ivf(1, ds.X, n_shards=n_shards, n_partitions=32,
                                    spill_mode=mode, train_iters=6, device=devices[0])
        build_s = time.time() - t0
        search = make_distributed_search(devices, top_t=6, final_k=10)
        ids, _ = search(sharded, ds.Q)                  # warm-up
        ids.cpu()
        t0 = time.time()
        for _ in range(3):
            ids, _ = search(sharded, ds.Q)
        ids = ids.cpu()
        dt = (time.time() - t0) / 3 / nq
        rec = (ids[:, :, None] == tn[:, None, :]).any(-1).float().mean()
        print(f"  {mode:5s} build {build_s:5.1f}s  recall@10={rec:.3f}  "
              f"{dt*1e6:.0f} us/query (8-way, incl. global merge)")


if __name__ == "__main__":
    main()
