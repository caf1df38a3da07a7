"""Vectors of a cell, made on the device from the run's seed.

A frozen copy of `repro_torch/data/vectors.py::make_manifold`'s formula,
x = normalize(W2 tanh(2 W1 z)) with z ~ N(0, I_p): unit-norm points on a
p-dimensional manifold, on which k-means underfits as it does on GloVe.
The copy lives here so that the benchmark's inputs stay the same when the
program changes. Unlike the program's version every draw is made on the
device by a `torch.Generator` there, in a few large calls:

- the manifold (W1, W2) from the configuration's `manifold_seed`, so that a
  configuration is one fixed dataset, as an ann-benchmarks file is;
- the points and queries from the run's seed.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

CHUNK = 1 << 20          # rows through the MLP at a time (bounds its (rows, hidden) buffer)
SEED_MASK = (1 << 63) - 1


class Vectors(NamedTuple):
    X: torch.Tensor       # (n, d) f32 database
    Q: torch.Tensor       # (nq, d) f32 queries


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & SEED_MASK)
    return g


def make(data: dict, seed: int, device) -> Vectors:
    """The configuration's `data` block → database and queries.

    data: n, d, nq, intrinsic_dim, hidden, manifold_seed."""
    n, d, nq = int(data["n"]), int(data["d"]), int(data["nq"])
    p, hidden = int(data["intrinsic_dim"]), int(data["hidden"])
    gw = generator(data["manifold_seed"], device)
    W1 = torch.randn((p, hidden), generator=gw, device=device) / math.sqrt(p)
    W2 = torch.randn((hidden, d), generator=gw, device=device) / math.sqrt(hidden)
    total = n + nq
    gz = generator(seed, device)
    out = torch.empty((total, d), dtype=torch.float32, device=device)
    for i0 in range(0, total, CHUNK):
        rows = min(CHUNK, total - i0)
        z = torch.randn((rows, p), generator=gz, device=device)
        x = torch.tanh(2.0 * (z @ W1)) @ W2
        out[i0:i0 + rows] = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return Vectors(out[:n], out[n:])
