"""Two-level centroid route (the TreeRouter probe stage): CUDA kernel and
its wrapper.

Replaces `repro/kernels/tree_route.py::tree_route_pallas`. Source:
`csrc/tree_route.cu`.

Bound on the H100: the bytes (the child rows and the (nq, t_route·cmax)
outputs) at routing shapes (S ≈ √c supers), a fraction of a microsecond
at c = 2,000; what the kernel pays is latency. One block of 16 warps per
query scores every super, selects all t_route supers at once by counting
the supers before each one in the order (value desc, index asc) — the
order `jax.lax.top_k` gives — and scores their child rows, 16 rows a warp
with their loads in flight together. The Pallas kernel's one-hot MXU
gathers and its VMEM gate are TPU workarounds and are not carried over; an
S whose scores do not fit in shared memory raises.

A router checks its tables once (`check_tables`) and then routes with
`checked=True`, so a call checks only the queries.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import tree_route_ref

SMEM_LIMIT = 232_448      # bytes of shared memory one block may use on sm_90


def check_tables(SC: torch.Tensor, CC: torch.Tensor, CH: torch.Tensor) -> None:
    """Raise unless (SC, CC, CH) are tables the kernel takes: contiguous
    (S, d) f32, (S, cmax, d) f32 and (S, cmax) int32 on one CUDA device,
    with the S super scores and a query in shared memory."""
    _build.require_cuda(SC, CC, CH)
    _build.check(SC, "SC", torch.float32, 2)
    _build.check(CC, "CC", torch.float32, 3)
    _build.check(CH, "CH", torch.int32, 2)
    S, cmax = CH.shape
    d = SC.shape[1]
    if SC.shape[0] != S or CC.shape != (S, cmax, d):
        raise ValueError(f"shape mismatch: SC {tuple(SC.shape)}, CC {tuple(CC.shape)}, "
                         f"CH {tuple(CH.shape)}")
    _check_smem(S, d, 1)


def _check_smem(S: int, d: int, t_route: int) -> None:
    smem = (d + S + t_route) * 4       # the query, S super scores, the chosen supers
    if smem > SMEM_LIMIT:
        raise ValueError(f"S={S}, d={d}, t_route={t_route}: the kernel needs {smem} "
                         f"bytes of shared memory, above the {SMEM_LIMIT} a block may use")


def tree_route(Q: torch.Tensor, SC: torch.Tensor, CC: torch.Tensor,
               CH: torch.Tensor, t_route: int, checked: bool = False):
    """Q (nq, d) f32, SC (S, d) f32, CC (S, cmax, d) f32, CH (S, cmax) int32
    → (scores (nq, t_route·cmax) f32, ids (nq, t_route·cmax) int32).

    Round r holds the children of the r-th best super; -inf and id -1
    where CH is -1. CPU tensors take the plain version; CUDA tensors launch
    the kernel. `checked=True` says `check_tables` passed on these tables
    already (a router's own), so only Q is checked here.
    """
    if _build.on_cpu(Q, SC, CC, CH):
        return tree_route_ref(Q, SC, CC, CH, t_route)
    if not checked:
        check_tables(SC, CC, CH)
    _build.require_cuda(Q, SC)
    _build.check(Q, "Q", torch.float32, 2)
    nq, d = Q.shape
    S, cmax = CH.shape
    t_route = int(t_route)
    if SC.shape[1] != d or not 1 <= t_route <= S:
        raise ValueError(f"shape mismatch: Q {tuple(Q.shape)}, SC {tuple(SC.shape)}, "
                         f"t_route {t_route} (need 1 <= t_route <= S)")
    _check_smem(S, d, t_route)
    w = t_route * cmax
    scores, ids = torch.empty((2, nq, w), dtype=torch.float32, device=Q.device).unbind(0)
    ids = ids.view(torch.int32)
    if scores.numel() == 0:
        return scores, ids
    _build.launch("tree_route_launch", Q, SC, CC, CH, nq, S, cmax, d, t_route,
                  _build.vec4(d, Q, SC, CC), scores, ids)
    tree_route.launches += 1
    return scores, ids


tree_route.launches = 0
