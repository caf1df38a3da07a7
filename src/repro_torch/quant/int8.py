"""Scalar int8 quantization of the rerank rows (PyTorch port of
`repro/quant/int8.py`).

One scale per row, amax / 127, and codes round(x / scale) clipped to
[-127, 127]. XLA compiles the JAX package's `amax / 127.0` as a product
with the f32 constant 1/127, so the scale is computed that way here too;
`torch.round` rounds half to even as `jnp.round` does, and every step is
one IEEE f32 operation, so the codes and scales equal the JAX package's
bit for bit, on the CPU and on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.spans import span


class Int8Data(NamedTuple):
    q: torch.Tensor        # (n, d) int8
    scale: torch.Tensor    # (n,) f32 per-row scale

    def to(self, device) -> "Int8Data":
        """Both tensors on `device` (themselves where they lie there)."""
        return Int8Data(self.q.to(device), self.scale.to(device))


def int8_quantize(X: torch.Tensor) -> Int8Data:
    """(n, d) f32 → Int8Data (codes (n, d) int8, scales (n,) f32). The
    span "int8.quantize"."""
    with span("int8.quantize"):
        X = X.to(torch.float32)
        amax = X.abs().amax(dim=-1).clamp(min=1e-12)
        scale = amax * torch.tensor(1.0 / 127.0, dtype=torch.float32, device=X.device)
        q = torch.round(X / scale[:, None]).clamp(-127, 127).to(torch.int8)
        return Int8Data(q, scale)


def int8_dequantize(data: Int8Data) -> torch.Tensor:
    """Int8Data → (n, d) f32 rows, code × scale."""
    return data.q.to(torch.float32) * data.scale[:, None]


def rerank_f32(rows) -> torch.Tensor:
    """A rerank table as (n, d) f32 rows: f32 rows as they are, Int8Data
    dequantized (for the paths that keep f32 rows: the shard-parallel
    search, the kNN memory's keys, the rebuild comparator)."""
    return int8_dequantize(rows) if isinstance(rows, Int8Data) else rows


def rerank_table(rows) -> torch.Tensor:
    """The (n, d) tensor of a rerank table: its f32 rows or its int8 codes."""
    return rows.q if isinstance(rows, Int8Data) else rows


def int8_score(q: torch.Tensor, data: Int8Data, ids: torch.Tensor) -> torch.Tensor:
    """MIPS scores of one query (d,) against the int8 rows `ids` (k,) → (k,)."""
    ids = ids.to(torch.int64)
    rows = data.q[ids].to(torch.float32) * data.scale[ids][:, None]
    return rows @ q
