"""int8-compressed gradient all-reduce with error feedback (PyTorch port
of `repro/train/grad_compress.py`).

Cross-pod data-parallel gradient reduction is the dominant inter-pod
collective at scale; int8 quantization cuts its bytes 4x (vs f32) at the
cost of quantization noise, which error feedback (residual carried between
steps) removes in expectation (Karimireddy et al., 2019 — "EF-SGD").

`compressed_all_reduce(x, group)` is JAX's `compressed_psum(x, axis_name)`
over a torch.distributed group: a two-phase reduce — the shared scale's
max (an all-reduce MAX of one f32) then an all-reduce SUM of the
quantized values carried as int32 — so its integers and its f32 scale are
JAX's, and so are its bits on the same inputs.
`compressed_all_reduce_with_feedback(x, err, group)` is
`compressed_psum_with_feedback`. The tensors go to the collective where
they lie (gloo's all-reduce takes CUDA tensors).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(x / scale) clipped to ±127 as int8 (half to even, as JAX)."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _scale(amax: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    # XLA folds the division by the constant 127 into a product with f32(1/127)
    return torch.clamp(amax, min=1e-12) * torch.tensor(1.0 / 127.0, dtype=torch.float32)


def _sum_int(q: torch.Tensor, group) -> torch.Tensor:
    total = q.to(torch.int32)
    dist.all_reduce(total, group=group)
    return total


def compressed_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8 sum of x over `group` (every rank gets the same result)."""
    scale = _scale(torch.max(torch.abs(x)).float(), group)
    return _sum_int(quantize(x, scale), group).to(x.dtype) * scale


def compressed_all_reduce_with_feedback(x: torch.Tensor, err: torch.Tensor, group=None):
    """Error-feedback variant: returns (reduced, new_err).

    new_err is THIS rank's local quantization residual; adding it to the
    next step's local gradient makes the long-run average unbiased.
    """
    scale = _scale(torch.max(torch.abs(x + err)).float(), group)
    corrected = x + err
    q = quantize(corrected, scale)
    new_err = corrected - q.to(x.dtype) * scale
    return _sum_int(q, group).to(x.dtype) * scale, new_err
