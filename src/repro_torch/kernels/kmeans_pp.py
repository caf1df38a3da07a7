"""k-means++ seeding: CUDA kernel and its wrapper.

`kmeans_pp` runs every pick of `core/kmeans.py::kmeans_pp_init_batched`
in one launch (source `csrc/kmeans_pp.cu`). It replaces no Pallas kernel:
the JAX package compiles the pick loop as a `lax.fori_loop`
(`repro/core/kmeans.py::kmeans_pp_init`); in eager PyTorch the same loop
(`ref.kmeans_pp_ref`, the plain version, which CPU tensors take) issues
~20 small operators a pick from the host.

Bound on the H100: latency. A pick reads the sample once (13 MB at
32,768 × 100, 4 µs at 3.35 TB/s), but each pick waits for the last
through two reductions over every row. The kernel is persistent: a team
of blocks, all resident, seeds one problem, each block holding a slice of
the rows in shared memory where it fits; a pick costs two barriers of the
team. `plan` sizes the teams from m, n and d: one problem over the whole
card (the codebook's 32,768-row sample), or one or two blocks a problem
(PQ's ~50 subspaces of d 2). The picks do not depend on the plan: the
float arithmetic is a row's own FMA chain, and the sums that draw are
int64.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch import spans
from repro_torch.kernels import _build
from repro_torch.kernels.pq_score import SMEM_LIMIT
from repro_torch.kernels.ref import d2_scale, kmeans_pp_ref

THREADS = 256           # threads a block (csrc/kmeans_pp.cu KP_THREADS)
MIN_ROWS = 64           # fewest rows a block of a team is given
STATIC_SMEM = 256       # the kernel's static shared memory, rounded up
# where a block reads its rows of X (csrc/kmeans_pp.cu): its shared
# memory, or device memory
X_SHARED, X_GLOBAL = 0, 1


class Plan(NamedTuple):
    teams: int          # problems seeded side by side
    blocks: int         # blocks a team
    rows: int           # rows a block (the last may hold fewer)
    stride4: int        # float4s a row in shared memory: odd, zero-padded
    xmode: int          # X_SHARED or X_GLOBAL
    state_shared: int   # 1: the rows' norms and distances in shared memory
    smem: int           # dynamic shared bytes a block


def plan(m: int, n: int, d: int, n_sms: int) -> Plan:
    """The launch of m problems of n rows of width d on a card of n_sms
    SMs, one block an SM: min(m, n_sms) teams of as many blocks as the SMs
    allow (at least MIN_ROWS rows a block), a block's rows in shared memory
    when they fit, else read from device memory, with the rows' norms and
    distances too when even those do not fit."""
    teams = min(m, n_sms)
    blocks = max(1, min(n_sms // teams, -(-n // MIN_ROWS), THREADS))
    rows = -(-n // blocks)
    blocks = -(-n // rows)
    stride4 = -(-d // 4) | 1
    cen, state, xbytes = 16 * stride4, 8 * rows, 16 * stride4 * rows
    budget = SMEM_LIMIT - STATIC_SMEM
    if cen + state + xbytes <= budget:
        return Plan(teams, blocks, rows, stride4, X_SHARED, 1, cen + state + xbytes)
    if cen > budget:
        raise ValueError(f"rows of width {d} do not fit the kernel's shared memory")
    if cen + state <= budget:
        return Plan(teams, blocks, rows, stride4, X_GLOBAL, 1, cen + state)
    return Plan(teams, blocks, rows, stride4, X_GLOBAL, 0, cen)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def kmeans_pp(X: torch.Tensor, first: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """k-means++ seeds of m problems: X (m, n, d) f32, first (m,) int64
    (each problem's first centre), u (c − 1, m) f32 uniforms in [0, 1) →
    centres (m, c, d), pick i drawn from u[i − 1].

    CPU tensors, and meta tensors (a dry run: shapes alone), take the
    plain version; CUDA tensors launch the kernel and count its picks as
    `fused_picks` into the innermost recording span.
    """
    if _build.on_cpu(X, first, u) or _build.on_meta(X, first, u):
        return kmeans_pp_ref(X, first, u)
    _build.require_cuda(X, first, u)
    return _launch(X, first, u)


def _launch(X: torch.Tensor, first: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    _build.check(X, "X", torch.float32, 3)
    _build.check(first, "first", torch.int64, 1)
    _build.check(u, "u", torch.float32, 2)
    m, n, d = X.shape
    c = u.shape[0] + 1
    if first.shape[0] != m or u.shape[1] != m or min(m, n, d) == 0:
        raise ValueError(f"unsupported shapes: X {tuple(X.shape)}, first "
                         f"{tuple(first.shape)}, u {tuple(u.shape)} (need m, n, d >= 1)")
    p = plan(m, n, d, _sms(X.device.index))
    dev = X.device
    cents = torch.empty((m, c, d), dtype=torch.float32, device=dev)
    done = torch.empty(m, dtype=torch.int32, device=dev)
    state = torch.empty((3, m, n), dtype=torch.float32, device=dev)   # norms, distances ×2
    bmax = torch.empty(p.teams * p.blocks, dtype=torch.float32, device=dev)
    bsum = torch.empty(p.teams * p.blocks, dtype=torch.int64, device=dev)
    bars = torch.empty(p.teams, dtype=torch.int32, device=dev)
    _build.launch("kmeans_pp_launch", X, first, u, m, n, d, c, d2_scale(n), p.teams,
                  p.blocks, p.rows, p.stride4, p.xmode, p.state_shared, p.smem, cents,
                  done, state[0], state[1:], bmax, bsum, bars)
    kmeans_pp.launches += 1
    spans.count(fused_picks=done)
    return cents


kmeans_pp.launches = 0
