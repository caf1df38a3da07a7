"""PQ LUT scoring: CUDA kernels and their wrappers.

`pq_score_probes` (each query's probed partitions, read by probe id from
the packed table) replaces `repro/kernels/pq_score.py::pq_score_window_pallas`
together with the window gather, the coarse term and the padding mask that
the search wrapped around it; source `csrc/pq_score_probes.cu`. `pq_score`
(dense: every query × every row) replaces `pq_score_pallas`, source
`csrc/pq_score.cu`. Both TPU kernels are one-hot MXU contractions.

Bound on the H100: memory, for both. The work is one LUT add per code
byte, so the least time is the bytes (codes read once, LUTs read once,
scores written once) over 3.35 TB/s. The designs answer that by reading
the codes as uint8, where the JAX wrappers widen them to int32 (four times
the bytes), and by holding LUTs in shared memory. The probe kernel reads
only the probed partitions' real rows, straight from the (c, pmax, m)
table, so no (nq, t·pmax, m) window is gathered in device memory and the
padding is never read. The dense kernel's output outweighs its codes, but
with its LUTs in shared memory it is held by the lookups (nq·n·m of them)
before the bytes: resident blocks keep a group of up to 64 queries' LUTs,
interleaved by query pair so one 64-bit shared load returns two queries'
entries, and stream code tiles past them; it stores along n.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import pq_score_probes_ref, pq_score_ref

SMEM_LIMIT = 232_448      # bytes of shared memory one block may use on sm_90


def pq_score_probes(luts: torch.Tensor, part_codes: torch.Tensor,
                    extent: torch.Tensor, parts: torch.Tensor,
                    psc: torch.Tensor) -> torch.Tensor:
    """luts (nq, m, 16) f32, part_codes (c, pmax, m) uint8, extent (c,)
    int32, parts (nq, t) int in [0, c), psc (nq, t) f32 → (nq, t·pmax) f32.

    out[q, j·pmax + i] = Σ_k luts[q, k, part_codes[parts[q, j], i, k]]
    + psc[q, j] for i < extent[parts[q, j]], −inf past it; codes must be
    < 16. extent[p] is partition p's slot extent (`PackedIVF.extent`):
    slots inside it whose id is −1 are scored too, and the search masks
    them by id. CPU tensors take the plain version; CUDA tensors launch
    the kernel; meta tensors (a dry run) give the output's shape and
    report the kernel's bytes (`_probe_bytes`) to `_build.report`.
    """
    args = (luts, part_codes, extent, parts, psc)
    if _build.on_cpu(*args):
        return pq_score_probes_ref(*args)
    if _build.on_meta(*args):
        return _meta_probes(*args)
    _build.require_cuda(*args)
    return _launch_probes(*args)


def _probe_bytes(nq: int, t: int, pmax: int, m: int, code_bytes: int) -> int:
    """Bytes the probe kernel must move: the probed code rows
    (`code_bytes`), the (nq, m, 16) f32 LUTs, the (nq, t) int64 probe ids,
    f32 coarse scores and the probed partitions' int32 extents read once,
    the (nq, t·pmax) f32 scores written once. chip_smoke.py's bound for the
    kernel counts the same."""
    return code_bytes + nq * m * 16 * 4 + nq * t * (8 + 4 + 4) + nq * t * pmax * 4


def _checked(luts, part_codes, extent, parts, psc):
    """The kernel's arguments validated → (parts as int64, psc contiguous,
    (nq, c, pmax, m, t))."""
    parts = parts.to(torch.int64).contiguous()
    psc = psc.contiguous()      # a router's top-t values may be a strided view
    _build.check(luts, "luts", torch.float32, 3)
    _build.check(part_codes, "part_codes", torch.uint8, 3)
    _build.check(extent, "extent", torch.int32, 1)
    _build.check(psc, "psc", torch.float32, 2)
    nq, m, k = luts.shape
    c, pmax, _ = part_codes.shape
    t = parts.shape[1] if parts.dim() == 2 else -1
    if (k != 16 or part_codes.shape[2] != m or extent.shape[0] != c
            or parts.shape != (nq, t) or psc.shape != (nq, t)):
        raise ValueError(f"shape mismatch: luts {tuple(luts.shape)}, part_codes "
                         f"{tuple(part_codes.shape)}, extent {tuple(extent.shape)}, "
                         f"parts {tuple(parts.shape)}, psc {tuple(psc.shape)}")
    return parts, psc, (nq, c, pmax, m, t)


def _meta_probes(luts, part_codes, extent, parts, psc) -> torch.Tensor:
    """The dry run's branch: the output on meta, and the kernel's work
    reported. The extent is data, so every probe counts pmax code rows:
    an upper bound on the rows a real index's probes read."""
    parts, psc, (nq, _, pmax, m, t) = _checked(luts, part_codes, extent, parts, psc)
    _build.report("pq_score_probes", _probe_bytes(nq, t, pmax, m, nq * t * pmax * m))
    return torch.empty((nq, t * pmax), dtype=torch.float32, device="meta")


def _launch_probes(luts, part_codes, extent, parts, psc) -> torch.Tensor:
    parts, psc, (nq, c, pmax, m, t) = _checked(luts, part_codes, extent, parts, psc)
    if part_codes.data_ptr() % 16:
        raise ValueError("part_codes must be 16-byte aligned (a fresh tensor)")
    out = torch.empty((nq, t * pmax), dtype=torch.float32, device=luts.device)
    if out.numel() == 0:
        return out
    _build.launch("pq_score_probes_launch", luts, part_codes, extent, parts, psc,
                  nq, c, pmax, m, t, out)
    pq_score_probes.launches += 1
    return out


pq_score_probes.launches = 0


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
    if _dense_smem(2, m) > SMEM_LIMIT:
        raise ValueError(f"m={m}: two queries' LUTs and the code ring need "
                         f"{_dense_smem(2, m)} bytes of shared memory, above "
                         f"the {SMEM_LIMIT} a block may use")
    if codes.data_ptr() % 16:
        codes = codes.clone()      # the kernel copies 16-byte chunks
    n = codes.shape[0]
    out = torch.empty((nq, n), dtype=torch.float32, device=luts.device)
    if out.numel() == 0:
        return out
    _build.launch("pq_score_launch", luts, codes, nq, n, m, out)
    pq_score.launches += 1
    return out


def _dense_smem(group: int, m: int) -> int:
    """Shared memory of the dense kernel's block: `group` queries' LUTs and
    two 256-row code tiles (`csrc/pq_score.cu::pq_smem`)."""
    return group * m * 16 * 4 + 2 * 256 * m


pq_score.launches = 0
