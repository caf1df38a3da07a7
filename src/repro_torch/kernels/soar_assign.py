"""SOAR spilled assignment: CUDA kernel, its wrapper, and `assign_fused`.

Replaces `repro/kernels/soar_assign.py::soar_assign_pallas`. Source:
`csrc/soar_assign.cu` over the tile loop in `csrc/assign.cuh`.

Bound on the H100: operations. Two dot products per (row, centroid), 4·n·c·d
f32 FLOPs, against (2n + c)·d·4 bytes read. The design answers that as the
vq kernel does (rows and centroid tiles staged in shared memory, 4 × 4
register micro-tiles, a running (min, argmin) per row, no (n × c) matrix in
device memory), and computes ⟨x, c⟩ and ⟨r̂, c⟩ from the same staged
centroid tile, so the tile is read once for both. The primary's column is
skipped in place of the Pallas kernel's +inf mask.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import soar_assign_ref
from repro_torch.kernels.vq_assign import vq_assign


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
    return _launch(X, rhat, primary, C, lam)


def _launch(X, rhat, primary, C, lam):
    _build.check(X, "X", torch.float32, 2)
    _build.check(rhat, "rhat", torch.float32, 2)
    _build.check(primary, "primary", torch.int32, 1)
    _build.check(C, "C", torch.float32, 2)
    n, d = X.shape
    c = C.shape[0]
    if (rhat.shape != X.shape or primary.shape[0] != n or C.shape[1] != d
            or c == 0 or d == 0):
        raise ValueError(f"shape mismatch: X {tuple(X.shape)}, rhat "
                         f"{tuple(rhat.shape)}, primary {tuple(primary.shape)}, "
                         f"C {tuple(C.shape)}")
    idx = torch.empty(n, dtype=torch.int32, device=X.device)
    val = torch.empty(n, dtype=torch.float32, device=X.device)
    if n == 0:
        return idx, val
    _build.launch("soar_assign_launch", X, rhat, primary, C, float(lam),
                  n, c, d, idx, val)
    soar_assign.launches += 1
    return idx, val


soar_assign.launches = 0


def assign_fused(X: torch.Tensor, C: torch.Tensor, lam: float = 1.0,
                 n_spills: int = 1) -> torch.Tensor:
    """Primary + spilled assignment against a frozen codebook.

    The TPU route of `repro/kernels/soar_assign.py::assign_fused`:
    n_spills=0 runs the vq kernel; n_spills=1 the vq kernel, the unit
    residual r̂ in plain torch, then the soar kernel. Returns
    (n, 1 + n_spills) int32, column 0 primary.
    """
    if n_spills > 1:
        raise NotImplementedError("multi-spill: later slice")
    X = X.to(torch.float32).contiguous()
    C = C.to(torch.float32).contiguous()
    prim, _ = vq_assign(X, C)
    if n_spills == 0:
        return prim[:, None]
    r = X - C[prim.to(torch.int64)]
    rhat = r / torch.linalg.vector_norm(r, dim=-1, keepdim=True).clamp(min=1e-12)
    sec, _ = soar_assign(X, rhat, prim, C, lam=lam)
    return torch.stack([prim, sec], dim=1)
