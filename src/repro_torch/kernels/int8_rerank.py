"""Exact rerank over int8 rows with the final top-k: CUDA kernel and its
wrapper.

Replaces no TPU kernel: the JAX package dequantizes its int8 rerank rows
into an (n, d) f32 table and reranks with a product, so an int8 index is
served at 4d bytes a row. Here the rows stay (n, d) int8 codes with (n,)
f32 scales, and a candidate's score is ⟨q, x₈⟩ accumulated in f32, times
the row's scale. Source `csrc/int8_rerank.cu`.

Bound on the H100: bytes, d + 4 a candidate's row and scale, read at
random; the kernel is built for latency (16 warps a query, 4 rows a warp
in flight) and chooses the top k in shared memory, so the (nq, budget)
scores are never written.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import int8_rerank_ref
from repro_torch.quant.int8 import Int8Data

SMEM_LIMIT = 232_448      # bytes of shared memory one block may use on sm_90


def int8_rerank(Q: torch.Tensor, rows: Int8Data, ids: torch.Tensor, approx: torch.Tensor,
                k: int):
    """Q (nq, d) f32, rows (n, d) int8 codes with (n,) f32 scales, ids
    (nq, B) int32, approx (nq, B) f32 → (ids (nq, k) int32, scores (nq, k)
    f32).

    A candidate is a slot whose approx score is finite; its score is
    ⟨Q[q], codes[id]⟩ · scale[id], every other slot's −inf. Each query's
    top k slots by (score descending, slot ascending), as `topk_first`
    gives, with their ids; ranks past B hold (−1, −inf). CPU tensors take
    the plain version (`ref.int8_rerank_ref`); CUDA tensors launch the
    kernel."""
    args = (Q, rows.q, rows.scale, ids, approx)
    if _build.on_cpu(*args):
        return int8_rerank_ref(Q, rows.q, rows.scale, ids, approx, k)
    _build.require_cuda(*args)
    Q, ids, approx = Q.contiguous(), ids.contiguous(), approx.contiguous()
    _build.check(Q, "Q", torch.float32, 2)
    _build.check(rows.q, "codes", torch.int8, 2)
    _build.check(rows.scale, "scale", torch.float32, 1)
    _build.check(ids, "ids", torch.int32, 2)
    _build.check(approx, "approx", torch.float32, 2)
    nq, d = Q.shape
    B = ids.shape[1]
    if (rows.q.shape[1] != d or rows.scale.shape[0] != rows.q.shape[0]
            or ids.shape[0] != nq or approx.shape != ids.shape or k < 1):
        raise ValueError(f"shape mismatch: Q {tuple(Q.shape)}, codes {tuple(rows.q.shape)}, "
                         f"scale {tuple(rows.scale.shape)}, ids {tuple(ids.shape)}, "
                         f"approx {tuple(approx.shape)}, k {k}")
    if (d + B) * 4 > SMEM_LIMIT:
        raise ValueError(f"d={d}, B={B}: the kernel holds {(d + B) * 4} bytes of shared "
                         f"memory, above the {SMEM_LIMIT} a block may use")
    out_ids = torch.empty((nq, k), dtype=torch.int32, device=Q.device)
    out_scores = torch.empty((nq, k), dtype=torch.float32, device=Q.device)
    if nq == 0:
        return out_ids, out_scores
    vec = int(d % 4 == 0 and rows.q.data_ptr() % 4 == 0)
    _build.launch("int8_rerank_launch", Q, rows.q, rows.scale, ids, approx, nq, B, d, int(k),
                  vec, out_ids, out_scores)
    int8_rerank.launches += 1
    return out_ids, out_scores


int8_rerank.launches = 0
