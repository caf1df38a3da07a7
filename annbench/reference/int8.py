"""Plain reference of the int8 rerank rows: one scale a row, amax times
the f32 constant 1/127 (amax at least 1e-12), codes the row over its
scale rounded half to even and clipped to ±127, as one IEEE f32 operation
each; a row's dequantized form is codes × scale."""
from __future__ import annotations

from typing import NamedTuple

import torch

BLOCK = 262_144           # rows a step


class Rows(NamedTuple):
    q: torch.Tensor        # (n, d) int8 codes
    scale: torch.Tensor    # (n,) f32


def quantize(X: torch.Tensor) -> Rows:
    """(n, d) f32 rows → their int8 codes and scales."""
    qs, ss = [], []
    inv = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=X.device)
    for i in range(0, X.shape[0], BLOCK):
        x = X[i:i + BLOCK].to(torch.float32)
        scale = x.abs().amax(1).clamp(min=1e-12) * inv
        qs.append(torch.round(x / scale[:, None]).clamp(-127, 127).to(torch.int8))
        ss.append(scale)
    return Rows(torch.cat(qs), torch.cat(ss))


def dequantize(r: Rows) -> torch.Tensor:
    """(n, d) f32: codes × scale."""
    return r.q.to(torch.float32) * r.scale[:, None]


def bad_rows(q: torch.Tensor, scale: torch.Tensor, want: Rows) -> int:
    """Rows whose codes or scale (bit for bit) differ from `want`'s."""
    codes = (q != want.q).any(1)
    scales = scale.view(torch.int32) != want.scale.view(torch.int32)
    return int((codes | scales).sum())
