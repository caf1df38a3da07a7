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

`host_staged_collectives` does the same for the functional collectives
(`_c10d_functional`) that DTensor issues: on torch 2.11 gloo's versions
of them crash (a segfault in `wait_tensor`, an all-gather even in a
one-rank group) or, in the backward pass, give wrong sums on CUDA
tensors, where its c10d all-reduce works (gloo's CUDA algorithms stage
through host memory themselves). Inside it each such collective of CUDA
tensors runs on host copies, waits, and its result comes back to the
card; the compute around it stays on the card. `launch/mesh.set_mesh`
enters it for a mesh of CUDA tensors over gloo.
"""
from __future__ import annotations

import contextlib
import functools
import warnings

import torch
import torch.distributed as dist
import torch.utils._pytree


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


# the functional collectives DTensor issues, out of place
_FUNCOLS = ("all_reduce", "all_reduce_coalesced", "all_gather_into_tensor",
            "all_gather_into_tensor_coalesced", "reduce_scatter_tensor",
            "reduce_scatter_tensor_coalesced", "all_to_all_single", "broadcast")


def _host(a):
    if isinstance(a, torch.Tensor):
        return a.cpu()
    if isinstance(a, (list, tuple)):
        return type(a)(_host(x) for x in a)
    return a


def _staged(op, *args, **kwargs):
    """op on host copies of its CUDA tensors, waited for, its outputs back
    on the card."""
    dev = next(t.device for t in torch.utils._pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor))
    out = op(*_host(args), **{k: _host(v) for k, v in kwargs.items()})
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    back = [torch.ops._c10d_functional.wait_tensor(t).to(dev) for t in outs]
    return type(out)(back) if isinstance(out, (list, tuple)) else back[0]


@contextlib.contextmanager
def host_staged_collectives():
    """For the block, each functional collective (`_c10d_functional`) of
    CUDA tensors runs on host copies (module docstring): a kernel of the
    op's CUDA dispatch key, so it holds on every thread (the backward
    pass's too) and inside other ops' handlers (DTensor's argmax gathers
    from within its own)."""
    lib = torch.library.Library("_c10d_functional", "IMPL")
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*Overriding a previously registered")
            for name in _FUNCOLS:
                op = getattr(torch.ops._c10d_functional, name).default
                lib.impl(name, functools.partial(_staged, op), "CUDA")
        yield
    finally:
        lib._destroy()
