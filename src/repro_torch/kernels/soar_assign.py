"""SOAR spilled assignment: CUDA kernel, its wrapper, and `assign_fused`.

Replaces `repro/kernels/soar_assign.py::soar_assign_pallas`. Source:
`csrc/soar_assign.cu` over the tensor-core tile loop of
`csrc/assign_tc.cuh` in its SOAR mode.

Bound on the H100: operations. Two products per (row, centroid), x·cᵀ and
r̂·cᵀ, 4·n·c·d multiply-adds at f32 accuracy against (2n + c)·d·4 bytes
read; they run as 3×TF32 on the tensor cores (3 × 4·n·c·d at 495
TFLOP/s: 0.318 ms at the build's shard of 65,536 × 2,000 × 100, plus the
6·n·c epilogue operations). The design is the vq kernel's loop (the
codebook prepared once, a `cp.async` ring of centroid fragments, no
(n × c) matrix in device memory, a running (min, argmin) per row) with
r̂ as a second operand: each block holds 64 rows of X and of r̂, split
into hi/lo, and every centroid fragment it loads feeds both products, so
the centroid tile is read once for both. 64 rows, not the vq kernel's 128,
keep both operands in shared memory and both sets of accumulators in
registers. The epilogue adds λ(⟨r̂,x⟩ − ⟨r̂,c⟩)² and skips the primary's
column by id in place of the Pallas kernel's +inf mask; a row whose only
centroid is its primary gets index 0 and +inf, as the plain version does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import soar_assign_ref, vq_assign_ref
from repro_torch.kernels.vq_assign import (PreparedCodebook, prepare_centroids,
                                           vq_assign_prepared)
from repro_torch.spans import span

SPILL_CHUNK = 8192     # rows per step of the plain spill columns


def soar_assign(X: torch.Tensor, rhat: torch.Tensor, primary: torch.Tensor,
                C: torch.Tensor, lam: float = 1.0):
    """X, rhat (n, d) f32, primary (n,) int32, C (c, d) f32 →
    (idx (n,) int32, loss at idx (n,) f32, incl. the ||x||² term).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    tensors = (X, rhat, primary, C)
    if _build.on_cpu(*tensors):
        return soar_assign_ref(X, rhat, primary, C, lam)
    _build.require_cuda(*tensors)
    return soar_assign_prepared(X, rhat, primary, prepare_centroids(C), lam)


def soar_assign_prepared(X: torch.Tensor, rhat: torch.Tensor, primary: torch.Tensor,
                         cb: PreparedCodebook, lam: float):
    """`soar_assign` on the card against a codebook prepared already."""
    _build.require_cuda(X, rhat, primary, cb.C)
    _build.check(X, "X", torch.float32, 2)
    _build.check(rhat, "rhat", torch.float32, 2)
    _build.check(primary, "primary", torch.int32, 1)
    n, d = X.shape
    c = cb.C.shape[0]
    if rhat.shape != X.shape or primary.shape[0] != n or cb.C.shape[1] != d:
        raise ValueError(f"shape mismatch: X {tuple(X.shape)}, rhat "
                         f"{tuple(rhat.shape)}, primary {tuple(primary.shape)}, "
                         f"C {tuple(cb.C.shape)}")
    idx = torch.empty(n, dtype=torch.int32, device=X.device)
    val = torch.empty(n, dtype=torch.float32, device=X.device)
    if n == 0:
        return idx, val
    _build.launch("soar_assign_launch", X, rhat, primary, cb.frags, cb.cn, float(lam),
                  n, c, d, _build.vec4(d, X, rhat), idx, val)
    soar_assign.launches += 1
    return idx, val


soar_assign.launches = 0


def unit_residuals(X: torch.Tensor, C: torch.Tensor, assign: torch.Tensor):
    """r̂ = (x − c_assign) / ||x − c_assign|| per row (0 where x = c)."""
    r = X - C[assign.to(torch.int64)]
    return r / torch.linalg.vector_norm(r, dim=-1, keepdim=True).clamp(min=1e-12)


def spill_columns(X: torch.Tensor, C: torch.Tensor, rhat: torch.Tensor,
                  assigned: torch.Tensor, lam: float, n_more: int,
                  chunk: int = SPILL_CHUNK) -> torch.Tensor:
    """Spill columns after the first, in plain torch: no Pallas kernel
    computes them in the JAX package (`_fused_assign_gemm` is jnp).

    assigned (n, 2) holds the primary and the first spill, rhat (n, d) the
    unit residual to the primary. Column j ≥ 2 minimizes ||c||² − 2⟨x,c⟩
    + λ·Σ_{k<j} (⟨r̂_k,x⟩ − ⟨r̂_k,c⟩)² over the centroids no earlier column
    took (r̂_k the unit residual to column k; the penalty sums in column
    order), ties to the lowest index, index 0 where every centroid is
    taken. Per chunk of rows: one x·Cᵀ product and one r̂_k·Cᵀ product per
    column, no buffer larger than (chunk, c). Returns (n, n_more) int32.
    """
    n = X.shape[0]
    cn = (C * C).sum(-1)
    out = torch.empty((n, n_more), dtype=torch.int32, device=X.device)
    for i0 in range(0, n, chunk):
        xb, rb = X[i0:i0 + chunk], rhat[i0:i0 + chunk]
        cols = assigned[i0:i0 + chunk].to(torch.int64)
        base = cn[None, :] - 2.0 * (xb @ C.T)
        pen = ((rb * xb).sum(-1)[:, None] - rb @ C.T) ** 2
        used = torch.zeros(base.shape, dtype=torch.bool, device=X.device)
        used.scatter_(1, cols, True)
        last = cols[:, -1]
        for j in range(n_more):
            rh = unit_residuals(xb, C, last)
            pen += ((rh * xb).sum(-1)[:, None] - rh @ C.T) ** 2
            loss = (base + lam * pen).masked_fill_(used, float("inf"))
            last = loss.argmin(-1)
            used.scatter_(1, last[:, None], True)
            out[i0:i0 + xb.shape[0], j] = last.to(torch.int32)
    return out


def assign_fused(X: torch.Tensor, C: torch.Tensor, lam: float = 1.0,
                 n_spills: int = 1) -> torch.Tensor:
    """Primary + spilled assignments against a frozen codebook.

    The TPU route of `repro/kernels/soar_assign.py::assign_fused`:
    n_spills=0 runs the vq kernel; n_spills ≥ 1 the vq kernel, the unit
    residual r̂ in plain torch, then the soar kernel, whose loss is the
    multi-spill objective's after one spill. On the card the codebook is
    prepared once for both launches. Columns after the first spill run in
    plain torch (`spill_columns`, the span "build.spill_columns"). Returns (n, 1 + n_spills) int32, column
    0 primary.
    """
    X = X.to(torch.float32).contiguous()
    C = C.to(torch.float32).contiguous()
    cpu = _build.on_cpu(X, C)
    if not cpu:
        _build.require_cuda(X, C)
        cb = prepare_centroids(C)
    prim = (vq_assign_ref(X, C) if cpu else vq_assign_prepared(X, cb))[0]
    if n_spills == 0:
        return prim[:, None]
    rhat = unit_residuals(X, C, prim)
    sec = (soar_assign_ref(X, rhat, prim, C, lam) if cpu
           else soar_assign_prepared(X, rhat, prim, cb, lam))[0]
    first = torch.stack([prim, sec], dim=1)
    if n_spills == 1:
        return first
    with span("build.spill_columns"):
        more = spill_columns(X, C, rhat, first, lam, n_spills - 1)
    return torch.cat([first, more], 1)
