"""PQ LUT scoring: CUDA kernels and their wrappers.

`pq_score_window` (per-query candidate windows) replaces
`repro/kernels/pq_score.py::pq_score_window_pallas`, source
`csrc/pq_score_window.cu`; `pq_score` (dense: every query × every row)
replaces `pq_score_pallas`, source `csrc/pq_score.cu`. Both TPU kernels are
one-hot MXU contractions.

Bound on the H100: memory, for both. The work is one LUT add per code
byte, so the least time is the bytes (codes read once, LUTs read once,
scores written once) over 3.35 TB/s. The designs answer that by reading
the codes as uint8, where the JAX wrappers widen them to int32 (four times
the bytes), by holding LUTs in shared memory, and by staging each block's
code tile with coalesced loads. The dense kernel's output outweighs its
codes, so it scores a staged tile against a few queries at once and
stores along n.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import pq_score_ref, pq_score_window_ref


def pq_score_window(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """luts (nq, m, 16) f32, codes (nq, cand, m) uint8 → (nq, cand) f32.

    score[q, i] = Σ_m luts[q, m, codes[q, i, m]]; codes must be < 16.
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if _build.on_cpu(luts, codes):
        return pq_score_window_ref(luts, codes)
    _build.require_cuda(luts, codes)
    return _launch(luts, codes)


def _launch(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    _build.check(luts, "luts", torch.float32, 3)
    _build.check(codes, "codes", torch.uint8, 3)
    nq, m, k = luts.shape
    if k != 16 or codes.shape[0] != nq or codes.shape[2] != m:
        raise ValueError(f"shape mismatch: luts {tuple(luts.shape)}, "
                         f"codes {tuple(codes.shape)}")
    cand = codes.shape[1]
    out = torch.empty((nq, cand), dtype=torch.float32, device=luts.device)
    if out.numel() == 0:
        return out
    _build.launch("pq_score_window_launch", luts, codes, nq, cand, m, out)
    pq_score_window.launches += 1
    return out


pq_score_window.launches = 0


def pq_score(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """luts (nq, m, 16) f32, codes (n, m) uint8 → (nq, n) f32.

    score[q, i] = Σ_m luts[q, m, codes[i, m]]; codes must be < 16.
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if _build.on_cpu(luts, codes):
        return pq_score_ref(luts, codes)
    _build.require_cuda(luts, codes)
    _build.check(luts, "luts", torch.float32, 3)
    _build.check(codes, "codes", torch.uint8, 2)
    nq, m, k = luts.shape
    if k != 16 or codes.shape[1] != m:
        raise ValueError(f"shape mismatch: luts {tuple(luts.shape)}, "
                         f"codes {tuple(codes.shape)}")
    n = codes.shape[0]
    out = torch.empty((nq, n), dtype=torch.float32, device=luts.device)
    if out.numel() == 0:
        return out
    _build.launch("pq_score_launch", luts, codes, nq, n, m, out)
    pq_score.launches += 1
    return out


pq_score.launches = 0
