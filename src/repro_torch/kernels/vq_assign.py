"""Nearest-centroid assignment: CUDA kernel and its wrapper.

Replaces `repro/kernels/vq_assign.py::vq_assign_pallas`. Source:
`csrc/vq_assign.cu` over the tensor-core tile loop of `csrc/assign_tc.cuh`,
the loop the Lloyd sweep's assignment runs too.

Bound on the H100: operations. 2·n·c·d multiply-adds at f32 accuracy
against (n + c)·d·4 bytes read; they run as 3×TF32 on the tensor cores
(3 × 2·n·c·d at 495 TFLOP/s: 0.159 ms at the build's shard of 65,536 ×
2,000 × 100). The design keeps the (n × c) distance matrix out of device
memory: the codebook is prepared once (its norms ‖c‖² and its hi/lo TF32
split in mma fragment order, `prepare_centroids`), each block of 128 rows
holds its split rows in shared memory (streamed through the copy ring
instead when d is too large for that) and walks every 128-centroid tile
through a 3-stage `cp.async` ring, `mma.sync` products accumulate in f32
registers, and only a running (min, argmin) per row survives a tile.
3×TF32 (lo·hi + hi·lo + hi·hi) keeps the argmin at f32 parity; ties go to
the lowest index.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import vq_assign_ref

# centroids per tile of the loop (csrc/assign_tc.cuh BN)
_BN = 128


class PreparedCodebook(NamedTuple):
    """A CUDA codebook made ready for the assignment kernels, once for
    every launch against it: its norms ‖c‖² and its hi/lo mma fragments."""
    C: torch.Tensor          # (c, d) f32
    cn: torch.Tensor         # (c,) f32
    frags: torch.Tensor      # csrc/assign_tc.cuh fragment_count(c, d) × 16 bytes


def centroid_scratch(C: torch.Tensor):
    """Empty (cn, frags) buffers for the prepared form of C (c, d)."""
    c, d = C.shape
    cn = torch.empty(c, dtype=torch.float32, device=C.device)
    frags = torch.empty(-(-c // _BN) * -(-d // 8) * (_BN // 8) * 32 * 4,
                        dtype=torch.int32, device=C.device)
    return cn, frags


def prepare_centroids(C: torch.Tensor) -> PreparedCodebook:
    """Norms and mma fragments of a CUDA codebook C (c, d) f32, c, d ≥ 1."""
    _build.require_cuda(C)
    _build.check(C, "C", torch.float32, 2)
    c, d = C.shape
    if c == 0 or d == 0:
        raise ValueError(f"empty codebook: C {tuple(C.shape)}")
    cn, frags = centroid_scratch(C)
    _build.launch("assign_prepare_launch", C, c, d, cn, frags)
    return PreparedCodebook(C, cn, frags)


def vq_assign(X: torch.Tensor, C: torch.Tensor):
    """X (n, d), C (c, d) f32 → (idx (n,) int32, sqdist (n,) f32).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if _build.on_cpu(X, C):
        return vq_assign_ref(X, C)
    _build.require_cuda(X, C)
    return vq_assign_prepared(X, prepare_centroids(C))


def vq_assign_prepared(X: torch.Tensor, cb: PreparedCodebook):
    """`vq_assign` on the card against a codebook prepared already."""
    _build.require_cuda(X, cb.C)
    _build.check(X, "X", torch.float32, 2)
    n, d = X.shape
    c = cb.C.shape[0]
    if cb.C.shape[1] != d:
        raise ValueError(f"shape mismatch: X {tuple(X.shape)}, C {tuple(cb.C.shape)}")
    idx = torch.empty(n, dtype=torch.int32, device=X.device)
    val = torch.empty(n, dtype=torch.float32, device=X.device)
    if n == 0:
        return idx, val
    _build.launch("vq_assign_launch", X, cb.frags, cb.cn, n, c, d, _build.vec4(d, X),
                  idx, val)
    vq_assign.launches += 1
    return idx, val


vq_assign.launches = 0
