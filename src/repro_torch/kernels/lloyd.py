"""Fused Lloyd sweep: CUDA kernel, its wrapper, and the batched sweep.

`lloyd_sweep` replaces `repro/kernels/lloyd.py::lloyd_sweep_pallas`.
Source: `csrc/lloyd.cu`, with the tensor-core tile loop of
`csrc/assign_tc.cuh` and the codebook preparation it shares with the
assignment kernels (`csrc/vq_assign.cu`).

Bound on the H100: operations. The assignment's 2·n·c·d products at f32
accuracy dwarf the n·d adds of the sums and the (n + 2c)·d·4 bytes moved;
they run as 3×TF32 on the tensor cores (3 × 2·n·c·d at 495 TFLOP/s). The
TPU kernel keeps the whole codebook in VMEM and accumulates across a
sequential grid; Hopper runs blocks in parallel with far less shared
memory, so the sweep is two phases: the assignment tile loop (no (n × c)
matrix in device memory), then an O(n) integer grouping (histogram,
scans, a stable scatter of row ids) and one warp per centroid summing its
rows in row order. No float atomics: the sweep returns the same bits on
every run.

`lloyd_sweep_batched` is plain torch: JAX runs it as a scan outside Pallas
on every backend (`repro/kernels/lloyd.py::lloyd_sweep_batched`).
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import lloyd_sweep_ref
from repro_torch.kernels.vq_assign import centroid_scratch

# below this feature dim the x·cᵀ contraction runs as an unrolled
# multiply-add chain, as in the JAX package (repro/kernels/lloyd.py SMALL_D)
SMALL_D = 8
# rows per block of the grouping passes (lloyd_group_launch)
GROUP_SEG = 2048


def lloyd_sweep(X: torch.Tensor, C: torch.Tensor):
    """One Lloyd iteration → (new_C (c, d), counts (c,) f32, mean distortion).

    Empty clusters keep their old centroid. CPU tensors take the plain
    version; CUDA tensors launch the kernel.
    """
    if _build.on_cpu(X, C):
        return lloyd_sweep_ref(X, C)
    _build.require_cuda(X, C)
    return _launch(X, C)


def _launch(X: torch.Tensor, C: torch.Tensor):
    _build.check(X, "X", torch.float32, 2)
    _build.check(C, "C", torch.float32, 2)
    n, d = X.shape
    c = C.shape[0]
    if C.shape[1] != d or n == 0 or c == 0 or d == 0 or d > 1024:
        raise ValueError(f"unsupported shapes: X {tuple(X.shape)}, "
                         f"C {tuple(C.shape)} (need n, c >= 1, 1 <= d <= 1024)")
    idx, mind = assign_phase(X, C)
    out = group_phase(X, C, idx, mind)
    lloyd_sweep.launches += 1
    lloyd_sweep.shapes[f"{n}x{c}x{d}"] += 1
    return out


def assign_phase(X: torch.Tensor, C: torch.Tensor):
    """The sweep's assignment launch alone (checked CUDA inputs) →
    (idx (n,) int32, squared distance (n,) f32)."""
    n, d = X.shape
    c = C.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=X.device)
    mind = torch.empty(n, dtype=torch.float32, device=X.device)
    cn, frags = centroid_scratch(C)
    _build.launch("lloyd_assign_launch", X, C, n, c, d, _build.vec4(d, X), cn, frags, idx,
                  mind)
    return idx, mind


def group_phase(X: torch.Tensor, C: torch.Tensor, idx: torch.Tensor,
                mind: torch.Tensor):
    """The sweep's grouping and ordered sums alone, from an assignment →
    (new_C (c, d), counts (c,) f32, mean distortion)."""
    n, d = X.shape
    c = C.shape[0]
    dev = X.device
    nb = -(-n // GROUP_SEG)
    ints = torch.empty(nb * c + 2 * c + n, dtype=torch.int32, device=dev)
    H, cnt, start, order = ints.split([nb * c, c, c, n])
    seg_loss = torch.empty(nb, dtype=torch.float32, device=dev)
    new_C = torch.empty_like(C)
    counts = torch.empty(c, dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    _build.launch("lloyd_group_launch", X, C, idx, mind, n, c, d,
                  _build.vec4(d, X, C, new_C), GROUP_SEG, H, cnt, start, order,
                  seg_loss, new_C, counts, loss)
    return new_C, counts, loss


lloyd_sweep.launches = 0
lloyd_sweep.shapes = Counter()     # launches by "n x c x d", counted with them


def batched_inner(xb: torch.Tensor, Cb: torch.Tensor) -> torch.Tensor:
    """(m, b, s) · (m, k, s)ᵀ → (m, b, k); small s as an unrolled chain."""
    s = Cb.shape[-1]
    if s > SMALL_D:
        return torch.bmm(xb, Cb.transpose(1, 2))
    acc = xb[..., 0:1] * Cb[:, None, :, 0]
    for j in range(1, s):
        acc = acc + xb[..., j:j + 1] * Cb[:, None, :, j]
    return acc


def lloyd_sweep_batched(Xb: torch.Tensor, Cb: torch.Tensor, chunk: int = 16384):
    """`lloyd_sweep` over a leading batch of m independent problems.

    Xb (m, n, s), Cb (m, k, s) → (new_C (m, k, s), counts (m, k), mean
    distortion (m,)). Per-centroid sums accumulate as a one-hot batched
    product per chunk: exact 0/1 weights and no atomics, so the result is
    the same on every run on every device.
    """
    m, n, _ = Xb.shape
    k = Cb.shape[1]
    cn = (Cb * Cb).sum(-1)[:, None, :]                       # (m, 1, k)
    sums = torch.zeros_like(Cb)
    counts = torch.zeros((m, k), dtype=Xb.dtype, device=Xb.device)
    loss = torch.zeros(m, dtype=Xb.dtype, device=Xb.device)
    for i0 in range(0, n, chunk):
        xb = Xb[:, i0:i0 + chunk]
        mv, idx = (cn - 2.0 * batched_inner(xb, Cb)).min(-1)        # (m, b)
        loss = loss + (mv + (xb * xb).sum(-1)).sum(-1)
        onehot = torch.nn.functional.one_hot(idx, k).to(Xb.dtype)  # (m, b, k)
        sums = sums + torch.bmm(onehot.transpose(1, 2), xb)
        counts = counts + onehot.sum(1)
    new_C = torch.where(counts[..., None] > 0,
                        sums / counts.clamp(min=1.0)[..., None], Cb)
    return new_C, counts, loss / n
