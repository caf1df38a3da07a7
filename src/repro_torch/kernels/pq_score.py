"""PQ LUT scoring: CUDA kernels and their wrappers.

`pq_score_probes` (each query's probed partitions, read by probe id from
the packed table) replaces `repro/kernels/pq_score.py::pq_score_window_pallas`
together with the window gather, the coarse term and the padding mask that
the search wrapped around it; source `csrc/pq_score_probes.cu`. Its
selecting form `pq_score_probes_select` (the search's PQ pass) writes no
window: it keeps each query's top slots on chip and returns them with
their ids, so the window's gather, mask and top-k go too. `pq_score`
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

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (pq_score_probes_ref, pq_score_probes_select_ref,
                                     pq_score_ref)

SMEM_LIMIT = 232_448      # bytes of shared memory one block may use on sm_90
SELECT_MAX = 2048         # the most slots a query the selecting form keeps on chip
_THREADS = 256            # csrc/pq_score_probes.cu::PR_THREADS


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


def pq_score_probes_select(luts: torch.Tensor, part_codes: torch.Tensor,
                           extent: torch.Tensor, parts: torch.Tensor, psc: torch.Tensor,
                           part_ids: torch.Tensor, keep: int,
                           filter: Optional[torch.Tensor] = None):
    """The probe scorer's selecting form: `pq_score_probes`'s arguments,
    plus part_ids (c, pmax) int32, keep and an optional (n,) uint8 filter
    over ids → (ids (nq, keep) int32, scores (nq, keep) f32).

    Each query's top `keep` candidates of its (t·pmax) window, by (score
    descending, window slot j·pmax + i ascending): what `topk_first`
    gives over `pq_score_probes`'s window once every slot that is no
    candidate is −inf. A candidate has a finite score, an id ≥ 0 and,
    given a filter, an id whose byte is not 0. Ranks past the candidates
    hold (−1, −inf). No window is written: on the card the scorer keeps
    each query's best slots in shared memory (`select_fits` says which
    keep and m it holds). CPU tensors take the plain version
    (`ref.pq_score_probes_select_ref`); meta tensors give the outputs'
    shapes and report the kernel's bytes (`_select_bytes`).
    """
    args = (luts, part_codes, extent, parts, psc, part_ids)
    every = args if filter is None else args + (filter,)
    if _build.on_cpu(*every):
        return pq_score_probes_select_ref(*args, keep, filter)
    if _build.on_meta(*every):
        return _meta_select(*args, keep, filter)
    _build.require_cuda(*every)
    return _launch_select(*args, keep, filter)


def select_fits(keep: int, m: int) -> bool:
    """Whether the selecting form holds `keep` slots a query on chip at m
    subspaces: 1 ≤ keep ≤ SELECT_MAX and its block's shared memory (the
    LUT, the code ring, the candidate buffer) within SMEM_LIMIT."""
    return 1 <= keep <= SELECT_MAX and _select_smem(keep, m) <= SMEM_LIMIT


def _select_smem(keep: int, m: int) -> int:
    """Shared memory of the selecting scorer's block
    (`csrc/pq_score_probes.cu`: the LUT, two code chunks, `pr_buffer`
    keys of 8 bytes, 256 digit counts, `keep` holes), plus 256 bytes for
    its static state."""
    chunk = (15 + _THREADS * m + 15) // 16 * 16
    buf = -(-(keep + max(keep, 1024)) // _THREADS) * _THREADS
    return m * 16 * 4 + 2 * chunk + buf * 8 + 256 * 4 + keep * 4 + 256


def _select_group(nq: int, t: int) -> int:
    """Probes a block of the selecting scorer takes: enough that the grid
    is about 640 blocks, one wave of the H100's 132 SMs at the 5 blocks a
    deep10m or glove tile fits on one, and at most 8. Fewer, longer
    blocks hand the merge fewer survivors; on an H100 80GB HBM3 at 700 W
    this rule came within about 1% of the best of 3 to 11 probes a block
    at glove's, deep10m's and the shard's tile shapes."""
    return max(1, min(8, -(-nq * t // 640)))


def _select_bytes(nq: int, t: int, keep: int, m: int, code_bytes: int,
                  filtered: bool) -> int:
    """Bytes the selecting form must move: `_probe_bytes`'s reads, then
    for each kept slot its id (and filter byte) read and its id and score
    written; no window."""
    return (code_bytes + nq * m * 16 * 4 + nq * t * (8 + 4 + 4)
            + nq * keep * (4 + int(filtered) + 4 + 4))


def _checked_select(luts, part_codes, extent, parts, psc, part_ids, keep, filter):
    parts, psc, dims = _checked(luts, part_codes, extent, parts, psc)
    _build.check(part_ids, "part_ids", torch.int32, 2)
    if part_ids.shape != part_codes.shape[:2]:
        raise ValueError(f"part_ids {tuple(part_ids.shape)} do not match part_codes "
                         f"{tuple(part_codes.shape)}")
    if filter is not None:
        _build.check(filter, "filter", torch.uint8, 1)
    if not select_fits(keep, dims[3]):
        raise ValueError(f"keep={keep} at m={dims[3]}: the selecting scorer holds "
                         f"1 to {SELECT_MAX} slots a query within {SMEM_LIMIT} bytes "
                         f"of shared memory")
    return parts, psc, dims


def _meta_select(luts, part_codes, extent, parts, psc, part_ids, keep, filter):
    """The dry run's branch: the outputs and the kernel's scratch on meta,
    and the kernel's bytes reported (every probe counts pmax code rows, as
    `_meta_probes`)."""
    parts, psc, (nq, _, pmax, m, t) = _checked_select(luts, part_codes, extent, parts,
                                                       psc, part_ids, keep, filter)
    _build.report("pq_score_probes_select",
                  _select_bytes(nq, t, keep, m, nq * t * pmax * m, filter is not None))
    groups = -(-t // _select_group(nq, t))
    torch.empty((nq, groups * keep), dtype=torch.int64, device="meta")
    return (torch.empty((nq, keep), dtype=torch.int32, device="meta"),
            torch.empty((nq, keep), dtype=torch.float32, device="meta"))


def _launch_select(luts, part_codes, extent, parts, psc, part_ids, keep, filter):
    parts, psc, (nq, c, pmax, m, t) = _checked_select(luts, part_codes, extent, parts,
                                                       psc, part_ids, keep, filter)
    if part_codes.data_ptr() % 16:
        raise ValueError("part_codes must be 16-byte aligned (a fresh tensor)")
    ids = torch.empty((nq, keep), dtype=torch.int32, device=luts.device)
    scores = torch.empty((nq, keep), dtype=torch.float32, device=luts.device)
    if nq == 0 or t == 0:
        return ids.fill_(-1), scores.fill_(float("-inf"))
    group = _select_group(nq, t)
    # each block's survivors, (nq, blocks a query, keep) 64-bit keys
    cand = torch.empty((nq, -(-t // group) * keep), dtype=torch.int64, device=luts.device)
    _build.launch("pq_score_probes_select_launch", luts, part_codes, extent, parts, psc,
                  part_ids, filter, nq, c, pmax, m, t, group, keep, cand, ids, scores)
    pq_score_probes_select.launches += 1
    return ids, scores


pq_score_probes_select.launches = 0


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
