"""Synthetic vector data for ANN experiments (PyTorch port of
`repro/data/vectors.py::make_manifold`).

A continuous low-intrinsic-dimension manifold, x = normalize(W2 tanh(2 W1 z)),
z ~ N(0, I_p): k-means underfits it, which gives the heavy tail of badly
ranked neighbours the paper's method addresses. The random draws come from
a numpy generator seeded with `seed`, so the numbers differ from the JAX
package's (jax.random) while shape and difficulty are the same.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.utils import Device, resolve_device

_CHUNK = 262_144


@dataclass(frozen=True)
class VectorDataset:
    X: torch.Tensor          # (n, d) float32, database
    Q: torch.Tensor          # (nq, d) float32, queries
    name: str

    @property
    def n(self) -> int:
        return self.X.shape[0]

    @property
    def d(self) -> int:
        return self.X.shape[1]


def make_manifold(seed: int, n: int, d: int, nq: int = 1000,
                  intrinsic_dim: int = 12, hidden: int = 256,
                  device: Device = None) -> VectorDataset:
    """n database rows and nq held-out queries from the same process.

    The MLP runs on `device` (CUDA unless the caller passes "cpu"),
    _CHUNK rows at a time.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    W1 = rng.standard_normal((intrinsic_dim, hidden), np.float32) / np.sqrt(intrinsic_dim)
    W2 = rng.standard_normal((hidden, d), np.float32) / np.sqrt(hidden)
    z = rng.standard_normal((n + nq, intrinsic_dim), np.float32)
    W1t = torch.from_numpy(W1.astype(np.float32)).to(dev)
    W2t = torch.from_numpy(W2.astype(np.float32)).to(dev)
    out = torch.empty((n + nq, d), dtype=torch.float32, device=dev)
    for i0 in range(0, n + nq, _CHUNK):
        zb = torch.from_numpy(z[i0:i0 + _CHUNK]).to(dev)
        x = torch.tanh(2.0 * (zb @ W1t)) @ W2t
        out[i0:i0 + zb.shape[0]] = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return VectorDataset(out[:n], out[n:], f"manifold-{n}-d{d}-p{intrinsic_dim}")
