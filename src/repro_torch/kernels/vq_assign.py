"""Nearest-centroid assignment: CUDA kernel and its wrapper.

Replaces `repro/kernels/vq_assign.py::vq_assign_pallas`. Source:
`csrc/vq_assign.cu` over the tile loop in `csrc/assign.cuh`.

Bound on the H100: operations. 2·n·c·d f32 FLOPs against (n + c)·d·4
bytes read, so at the build's shapes (65,536 × 2,000 × 100) the f32 rate
(67 TFLOP/s), not memory, sets the least time. The design answers that by
keeping the (n × c) distance matrix out of device memory: each block
stages a tile of rows and walks every centroid tile through shared memory,
each thread holds a 4 × 4 micro-tile of dot products in registers, and
only a running (min, argmin) per row survives a tile. Plain f32 FMAs, no
TF32, so the argmin matches the f32 reference. Ties go to the lowest index.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import vq_assign_ref


def vq_assign(X: torch.Tensor, C: torch.Tensor):
    """X (n, d), C (c, d) f32 → (idx (n,) int32, sqdist (n,) f32).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if _build.on_cpu(X, C):
        return vq_assign_ref(X, C)
    _build.require_cuda(X, C)
    return _launch(X, C)


def _launch(X: torch.Tensor, C: torch.Tensor):
    _build.check(X, "X", torch.float32, 2)
    _build.check(C, "C", torch.float32, 2)
    n, d = X.shape
    c = C.shape[0]
    if C.shape[1] != d or c == 0 or d == 0:
        raise ValueError(f"shape mismatch: X {tuple(X.shape)}, C {tuple(C.shape)}")
    idx = torch.empty(n, dtype=torch.int32, device=X.device)
    val = torch.empty(n, dtype=torch.float32, device=X.device)
    if n == 0:
        return idx, val
    _build.launch("vq_assign_launch", X, C, n, c, d, idx, val)
    vq_assign.launches += 1
    return idx, val


vq_assign.launches = 0
