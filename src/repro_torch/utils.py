"""Shared helpers: device resolution and float32 precision, the stable
top-k, chunked exact nearest-centroid and exact MIPS top-k."""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

Device = Union[str, torch.device, None]


def set_f32_precision() -> None:
    """Full float32 matrix products on the card (no TF32), and bf16
    products accumulated in f32 throughout, as XLA accumulates them.

    Argmin parity with the f32 references depends on it: TF32 keeps about
    three decimal digits, enough to flip near-tied centroid choices. A
    reduced-precision bf16 reduction (torch's default) rounds partial sums
    to bf16 inside a product.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: Device = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises where CUDA is asked for (or implied) and there is no
    card — never continues on the CPU silently."""
    set_f32_precision()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch: no CUDA device found; pass "
                           "device='cpu' to run on the CPU")
    return dev


def as_tensor(x, device: torch.device, dtype: Optional[torch.dtype] = None):
    """numpy array or tensor → tensor on `device`. A tensor already there
    is returned as it is; an array is copied (it may be read-only)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x), device=device, dtype=dtype)


def topk_first(x: torch.Tensor, k: int):
    """Top-k along the last axis with ties to the lowest index, as
    `jax.lax.top_k` gives (a stable descending sort)."""
    v, pos = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], pos[..., :k]


def pairwise_neg_sqdist_argmin(X: torch.Tensor, C: torch.Tensor,
                               chunk: int = 16384):
    """argmin_j ||x_i − c_j||² and the min value, chunked over rows of X.

    Returns (idx (n,) int32, min sqdist (n,) incl. ||x||²)."""
    cn = (C * C).sum(-1)
    idx = torch.empty(X.shape[0], dtype=torch.int32, device=X.device)
    val = torch.empty(X.shape[0], dtype=X.dtype, device=X.device)
    for i0 in range(0, X.shape[0], chunk):
        xb = X[i0:i0 + chunk]
        v, j = (cn[None, :] - 2.0 * (xb @ C.T)).min(-1)
        idx[i0:i0 + xb.shape[0]] = j.to(torch.int32)
        val[i0:i0 + xb.shape[0]] = v + (xb * xb).sum(-1)
    return idx, val


def topk_inner_product(Q: torch.Tensor, X: torch.Tensor, k: int,
                       chunk: int = 8192):
    """Exact MIPS top-k of each query against X, chunked over X.

    Returns (values (nq, k), indices (nq, k) int32); memory bounded by
    nq·(chunk + k)."""
    nq = Q.shape[0]
    bv = torch.full((nq, k), float("-inf"), dtype=Q.dtype, device=Q.device)
    bi = torch.full((nq, k), -1, dtype=torch.int64, device=Q.device)
    for i0 in range(0, X.shape[0], chunk):
        xb = X[i0:i0 + chunk]
        s = Q @ xb.T
        ids = torch.arange(i0, i0 + xb.shape[0], device=Q.device)
        cv = torch.cat([bv, s], dim=1)
        ci = torch.cat([bi, ids[None, :].expand(nq, -1)], dim=1)
        bv, pos = torch.topk(cv, k, dim=1)
        bi = torch.gather(ci, 1, pos)
    return bv, bi.to(torch.int32)
