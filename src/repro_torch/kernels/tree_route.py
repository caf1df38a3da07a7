"""Two-level centroid route (the TreeRouter probe stage): CUDA kernel and
its wrapper.

Replaces `repro/kernels/tree_route.py::tree_route_pallas`. Source:
`csrc/tree_route.cu`.

Bound on the H100: memory at routing shapes (S ≈ √c supers). The work is
2·nq·(S + t_route·cmax)·d FLOPs; the tables, the queries and the
(nq, t_route·cmax) outputs outweigh it at the f32 rate. One block per query
keeps q and its S super scores in shared memory, picks the t_route supers
by rounds of a lexicographic (value desc, index asc) warp argmax — the
order `jax.lax.top_k` gives — and scores the chosen supers' child rows
straight from global memory. The Pallas kernel's one-hot MXU gathers and
its VMEM gate are TPU workarounds and are not carried over; an S whose
scores do not fit in shared memory raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import tree_route_ref

SMEM_LIMIT = 232_448      # bytes of shared memory one block may use on sm_90


def tree_route(Q: torch.Tensor, SC: torch.Tensor, CC: torch.Tensor,
               CH: torch.Tensor, t_route: int):
    """Q (nq, d) f32, SC (S, d) f32, CC (S, cmax, d) f32, CH (S, cmax) int32
    → (scores (nq, t_route·cmax) f32, ids (nq, t_route·cmax) int32).

    Round r holds the children of the r-th best super; -inf and id -1
    where CH is -1. CPU tensors take the plain version; CUDA tensors launch
    the kernel.
    """
    tensors = (Q, SC, CC, CH)
    if _build.on_cpu(*tensors):
        return tree_route_ref(Q, SC, CC, CH, t_route)
    _build.require_cuda(*tensors)
    return _launch(Q, SC, CC, CH, int(t_route))


def _launch(Q, SC, CC, CH, t_route: int):
    _build.check(Q, "Q", torch.float32, 2)
    _build.check(SC, "SC", torch.float32, 2)
    _build.check(CC, "CC", torch.float32, 3)
    _build.check(CH, "CH", torch.int32, 2)
    nq, d = Q.shape
    S, cmax = CH.shape
    if SC.shape != (S, d) or CC.shape != (S, cmax, d) or not 1 <= t_route <= S:
        raise ValueError(f"shape mismatch: Q {tuple(Q.shape)}, SC {tuple(SC.shape)}, "
                         f"CC {tuple(CC.shape)}, CH {tuple(CH.shape)}, "
                         f"t_route {t_route} (need 1 <= t_route <= S)")
    smem = (d + S) * 4 + t_route * 4 + S
    if smem > SMEM_LIMIT:
        raise ValueError(f"S={S}, d={d}: the kernel needs {smem} bytes of shared "
                         f"memory, above the {SMEM_LIMIT} a block may use")
    w = t_route * cmax
    scores = torch.empty((nq, w), dtype=torch.float32, device=Q.device)
    ids = torch.empty((nq, w), dtype=torch.int32, device=Q.device)
    if scores.numel() == 0:
        return scores, ids
    _build.launch("tree_route_launch", Q, SC, CC, CH, nq, S, cmax, d, t_route,
                  scores, ids)
    tree_route.launches += 1
    return scores, ids


tree_route.launches = 0
