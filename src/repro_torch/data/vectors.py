"""Synthetic vector data for ANN experiments (PyTorch port of
`repro/data/vectors.py`).

- `make_manifold`: a continuous low-intrinsic-dimension manifold,
  x = normalize(W2 tanh(2 W1 z)), z ~ N(0, I_p): k-means underfits it,
  which gives the heavy tail of badly ranked neighbours the paper's method
  addresses (`glove_like` is its default benchmark set, cached).
- `make_clustered`: zipf-sized anisotropic Gaussian clusters, unit norm.
- `make_uniform`: unit-norm Gaussian points, the unstructured control.

The random draws come from a numpy generator seeded with `seed`, so the
numbers differ from the JAX package's (jax.random) while shapes and
statistics are the same.
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


def _unit(a: np.ndarray) -> np.ndarray:
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def _dataset(X: np.ndarray, Q: np.ndarray, name: str, device: Device) -> VectorDataset:
    dev = resolve_device(device)
    return VectorDataset(torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(dev),
                         torch.from_numpy(np.ascontiguousarray(Q, np.float32)).to(dev),
                         name)


def make_clustered(seed: int, n: int, d: int, n_clusters: int = 256, nq: int = 1000,
                   intra_scale: float = 0.35, zipf_a: float = 1.2,
                   normalize: bool = True, name: str = "synthetic",
                   device: Device = None) -> VectorDataset:
    """GloVe-like clusters: unit-norm centers with zipf(zipf_a) weights,
    per-cluster diagonal noise scales in [0.5, 1.5) × intra_scale; queries
    are held-out points with N(0, 0.05²) noise."""
    rng = np.random.default_rng(seed)
    centers = _unit(rng.standard_normal((n_clusters, d), np.float32))
    w = np.arange(1, n_clusters + 1, dtype=np.float64) ** (-zipf_a)
    assign = rng.choice(n_clusters, n + nq, p=w / w.sum())
    scales = 0.5 + rng.random((n_clusters, d), np.float32)
    noise = rng.standard_normal((n + nq, d), np.float32) * intra_scale * scales[assign]
    pts = centers[assign] + noise
    if normalize:
        pts = _unit(pts)
    Q = pts[n:] + rng.standard_normal((nq, d), np.float32) * 0.05
    if normalize:
        Q = _unit(Q)
    return _dataset(pts[:n], Q, name, device)


def make_uniform(seed: int, n: int, d: int, nq: int = 1000, name: str = "uniform",
                 device: Device = None) -> VectorDataset:
    """Unit-norm Gaussian database and queries (the near-orthogonal regime)."""
    rng = np.random.default_rng(seed)
    X = _unit(rng.standard_normal((n, d), np.float32))
    Q = _unit(rng.standard_normal((nq, d), np.float32))
    return _dataset(X, Q, name, device)


_CACHE: dict = {}


def glove_like(n: int = 200_000, d: int = 100, nq: int = 1000, seed: int = 0,
               intrinsic_dim: int = 12, device: Device = None) -> VectorDataset:
    """The default benchmark set, `make_manifold` (cached per process)."""
    key = ("glove_like", n, d, nq, seed, intrinsic_dim, str(resolve_device(device)))
    if key not in _CACHE:
        ds = make_manifold(seed, n, d, nq=nq, intrinsic_dim=intrinsic_dim, device=device)
        _CACHE[key] = VectorDataset(ds.X, ds.Q, f"manifold-{n // 1000}k-d{d}-p{intrinsic_dim}")
    return _CACHE[key]
