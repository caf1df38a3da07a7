"""Product quantization with 16 centers per subspace (PyTorch port of
`repro/quant/pq.py`).

All m subspaces train jointly: one batched k-means++ seeding and one
batched Lloyd sweep per iteration over the (m, sample, s) tensor, with a
host-side per-subspace mask that freezes a subspace once its distortion
stops improving (the JAX package's early-stop schedule).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.lloyd import batched_inner, lloyd_sweep_batched
from repro_torch.kernels.ref import pq_score_ref
from repro_torch.spans import span

PQ_KMEANS_CHUNK = 16_384
PQ_TRAIN_SAMPLE = 32_768
_INIT_SAMPLE = 50_000


def _sweep_chunk(n: int) -> int:
    """Even sweep tiling for n rows (as `repro/quant/pq.py::_sweep_chunk`)."""
    nch = -(-n // PQ_KMEANS_CHUNK)
    return min(PQ_KMEANS_CHUNK, -(-(-(-n // nch)) // 256) * 256)


class PQCodebook(NamedTuple):
    centers: torch.Tensor   # (m, 16, s) f32 — m subspaces, 16 centers, s dims


def _sample_rows(gen: torch.Generator, n: int, size: int) -> torch.Tensor:
    """`size` distinct row indices of range(n), drawn on the host."""
    return torch.randperm(n, generator=gen)[:size]


def train_pq(gen: torch.Generator, X: torch.Tensor, n_subspaces: int,
             n_centers: int = 16, iters: int = 8,
             sample: int = PQ_TRAIN_SAMPLE, tol: float = 1e-5,
             init_sample: int = _INIT_SAMPLE) -> PQCodebook:
    """Train per-subspace k-means codebooks on (a sample of) X, batched.
    The row samples, the seeding and the sweeps are the spans "pq.sample",
    "pq.seed" and "pq.lloyd" (`repro_torch.spans`)."""
    from repro_torch.core.kmeans import _stopped, kmeans_pp_init_batched

    n, d = X.shape
    if d % n_subspaces:
        raise ValueError(f"d={d} is not a multiple of {n_subspaces} subspaces")
    m, s = n_subspaces, d // n_subspaces
    X = X.to(torch.float32)
    with span("pq.sample"):
        if n > sample:
            X = X[_sample_rows(gen, n, sample).to(X.device)]
            n = sample
        Xm = X.reshape(n, m, s).permute(1, 0, 2).contiguous()     # (m, n, s)
        if n > init_sample:
            isel = torch.stack([_sample_rows(gen, n, init_sample)
                                for _ in range(m)]).to(X.device)
            Xi = torch.gather(Xm, 1, isel[..., None].expand(-1, -1, s))
        else:
            Xi = Xm
    with span("pq.seed"):
        C = kmeans_pp_init_batched(gen, Xi, n_centers)

    active = np.ones(m, bool)
    prev = np.full(m, np.inf)
    chunk = _sweep_chunk(n)
    with span("pq.lloyd"):
        for _ in range(iters):
            newC, _, dist = lloyd_sweep_batched(Xm, C, chunk=chunk)
            act = torch.as_tensor(active, device=X.device)
            C = torch.where(act[:, None, None], newC, C)
            dvals = dist.cpu().numpy()
            for j in np.nonzero(active)[0]:
                dj = float(dvals[j])
                if _stopped(prev[j], dj, tol):
                    active[j] = False
                else:
                    prev[j] = dj
            if not active.any():
                break
    return PQCodebook(C)


def train_pq_sequential(gen: torch.Generator, X: torch.Tensor, n_subspaces: int,
                        n_centers: int = 16, iters: int = 8,
                        sample: int = PQ_TRAIN_SAMPLE,
                        init_sample: int = _INIT_SAMPLE) -> PQCodebook:
    """The reference of `train_pq`: m host-looped `train_kmeans` calls, one
    per subspace, each with a generator seeded from `gen`."""
    from repro_torch.core.kmeans import train_kmeans

    n, d = X.shape
    if d % n_subspaces:
        raise ValueError(f"d={d} is not a multiple of {n_subspaces} subspaces")
    s = d // n_subspaces
    X = X.to(torch.float32)
    if n > sample:
        X = X[_sample_rows(gen, n, sample).to(X.device)]
    seeds = torch.randint(0, 2 ** 62, (n_subspaces,), generator=gen).tolist()
    Xs = X.reshape(X.shape[0], n_subspaces, s)
    return PQCodebook(torch.stack([
        train_kmeans(torch.Generator().manual_seed(seed), Xs[:, j].contiguous(),
                     n_centers, iters=iters, init_sample=init_sample).centroids
        for j, seed in enumerate(seeds)]))


def _encode_block(centers: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """(chunk, m, s) residual tile → (chunk, m) uint8 codes.

    Nearest center per subspace by ||c||² − 2⟨x, c⟩ (the ||x||² term is
    constant per row and subspace), first index on ties; small subspace
    dims contract as an unrolled multiply-add chain, as in the JAX package.
    """
    cn = (centers * centers).sum(-1)[:, None, :]              # (m, 1, k)
    dm = cn - 2.0 * batched_inner(xb.transpose(0, 1), centers)  # (m, chunk, k)
    return dm.argmin(-1).T.to(torch.uint8)


def pq_encode(cb: PQCodebook, X: torch.Tensor, chunk: int = 16384) -> torch.Tensor:
    """Encode rows of X → (n, m) uint8 codes, `chunk` rows at a time."""
    n, _ = X.shape
    m, _, s = cb.centers.shape
    out = torch.empty((n, m), dtype=torch.uint8, device=X.device)
    for i0 in range(0, n, chunk):
        xb = X[i0:i0 + chunk]
        out[i0:i0 + xb.shape[0]] = _encode_block(cb.centers,
                                                 xb.reshape(-1, m, s))
    return out


def pq_lut(cb: PQCodebook, Q: torch.Tensor) -> torch.Tensor:
    """Inner-product lookup tables: (nq, m, 16) for (nq, d) queries.

    score(q, decode(code)) == Σ_m lut[q, m, code[m]].
    """
    m, _, s = cb.centers.shape
    lut = torch.einsum("qms,mks->qmk", Q.reshape(Q.shape[0], m, s), cb.centers)
    return lut.contiguous()     # einsum may return a permuted view


def pq_decode(cb: PQCodebook, codes: torch.Tensor) -> torch.Tensor:
    """(n, m) codes → (n, d) reconstruction, each subspace's center."""
    m = cb.centers.shape[0]
    sub = torch.arange(m, device=codes.device)
    return cb.centers[sub[None, :], codes.to(torch.int64)].reshape(codes.shape[0], -1)


def pq_score(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Asymmetric PQ scores of one query: (m, 16) LUT × (n, m) codes → (n,)."""
    m = lut.shape[0]
    sub = torch.arange(m, device=codes.device)
    return lut[sub[None, :], codes.to(torch.int64)].sum(-1)


def pq_score_batch(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(nq, m, 16) LUTs × (n, m) codes → (nq, n) scores, as a LUT gather (the
    JAX package's one-hot product is a TPU formulation of the same sums)."""
    return pq_score_ref(luts, codes)
