"""Differentiable collectives over torch.distributed (the port's
counterparts of JAX's `psum` and `ppermute` inside shard_map, with their
transposes):

- `sum_shared(x, group)`: all-reduce (sum) forward, identity backward.
  Each rank holds a partial; every rank then uses the sum alike, so each
  rank's gradient of the sum is already the gradient of its partial.
- `sum_grads(x, group)`: identity forward, all-reduce (sum) of the
  gradient backward. A replicated input that each rank reads for its own
  part of the work gets the sum of every rank's gradient.
- `shift(x, group)`: rank r's x goes to rank r+1 (cyclic) and rank r gets
  rank r−1's; the backward pass sends the gradient the other way.

The ops never initialise a process group. gloo's all-reduce takes CUDA
tensors; its send and receive read host memory, so `shift` hands a CUDA
tensor to gloo through a host copy (NCCL takes it as it lies).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


class _SumShared(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _exchange(x: torch.Tensor, to: int, frm: int, group) -> torch.Tensor:
    """Send x to group rank `to` and receive a tensor like x from group rank
    `frm` (posted together, so a ring cannot deadlock)."""
    host = x.is_cuda and dist.get_backend(group) == "gloo"
    send = (x.cpu() if host else x).contiguous()
    recv = torch.empty_like(send)
    req = dist.isend(send, dist.get_global_rank(group, to), group=group)
    dist.recv(recv, dist.get_global_rank(group, frm), group=group)
    req.wait()
    return recv.to(x.device) if host else recv


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        r, n = dist.get_rank(group), dist.get_world_size(group)
        return _exchange(x, (r + 1) % n, (r - 1) % n, group)

    @staticmethod
    def backward(ctx, g):
        r, n = dist.get_rank(ctx.group), dist.get_world_size(ctx.group)
        return _exchange(g, (r - 1) % n, (r + 1) % n, ctx.group), None


def sum_shared(x: torch.Tensor, group) -> torch.Tensor:
    return _SumShared.apply(x, group)


def sum_grads(x: torch.Tensor, group) -> torch.Tensor:
    return _SumGrads.apply(x, group)


def shift(x: torch.Tensor, group) -> torch.Tensor:
    return _Shift.apply(x, group)
