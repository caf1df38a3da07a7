"""AdamW + global-norm clipping + warmup-cosine schedule (PyTorch port of
`repro/train/optimizer.py`).

JAX's formula and order of operations, not `torch.optim.AdamW`'s (which
places ε and the decay elsewhere):
    g ← g · min(1, clip / max(‖g‖, 1e-12));  m ← b1·m + (1−b1)·g;
    v ← b2·v + (1−b2)·g²;  p ← p − lr·(m̂ / (√v̂ + ε) + wd·p)
with m̂ = m / (1 − b1^step), v̂ = v / (1 − b2^step) in f32 and `grad_norm`
reported before the clip. Trees are nested dicts of tensors (the model's
parameter layout). `update` works in place on params, grads and the
state's m and v, the way the JAX step donates them, and walks each leaf
in chunks so the temporaries stay small at full width; every operation
is elementwise, so the chunks change no bit. DTensor leaves (a sharded
model, `models/params.distribute`) are updated shard by shard, each rank
its own; the norm sums each shard's squares across the mesh.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models import params as prm

CHUNK = 1 << 24          # elements of a leaf updated at a time


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32, 0-d
    m: dict
    v: dict


def init(params) -> AdamWState:
    leaf = next(t for _, t in prm.leaf_paths(params))
    return AdamWState(torch.zeros((), dtype=torch.int32, device=leaf.device),
                      prm.tree_map(torch.zeros_like, params),
                      prm.tree_map(torch.zeros_like, params))


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """x as a 0-d f32 tensor on like's device: dividing by it is a true
    division on CUDA too (a Python divisor becomes a product with its
    reciprocal there)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  final_frac: float = 0.1):
    """step (int32 tensor) → lr (f32 0-d tensor), in f32 as JAX's."""
    def lr(step):
        step = step.to(torch.float32)
        warm = base_lr * (step + 1) / _scalar(max(warmup, 1), step)
        prog = torch.clamp((step - warmup) / _scalar(max(total - warmup, 1), step),
                           0.0, 1.0)
        cos = base_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr


def _chunks(t: torch.Tensor):
    """A leaf's elements CHUNK at a time; a DTensor's are its own shard's
    (chunks of its global view would not be this rank's memory)."""
    if isinstance(t, DTensor):
        t = t.to_local()
    flat = t.view(-1)
    return [flat[i:i + CHUNK] for i in range(0, flat.numel(), CHUNK)]


def _sum_sq(x: torch.Tensor) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(c.float())) for c in _chunks(x))
    if isinstance(x, DTensor):
        # one shard's sum: summed over the mesh dims that shard x
        pl = [Partial() if isinstance(p, Shard) else Replicate() for p in x.placements]
        sq = DTensor.from_local(sq, x.device_mesh, pl, run_check=False).full_tensor()
    return sq


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, leaves in JAX's
    (sorted) order."""
    total = 0
    for _, x in prm.leaf_paths(tree):
        total = total + _sum_sq(x)
    return torch.sqrt(total)


def update(grads, state: AdamWState, params, lr_fn, *, b1=0.9, b2=0.95,
           eps=1e-8, weight_decay=0.1, clip_norm=1.0):
    """Returns (params, state, metrics), params and the state updated in
    place (grads are scaled in place by the clip)."""
    gn = global_norm(grads)
    scale = torch.clamp(_scalar(clip_norm, gn) / torch.clamp(gn, min=1e-12), max=1.0)
    step = state.step + 1
    now = step.to_local() if isinstance(step, DTensor) else step   # replicated
    bc1 = 1 - torch.pow(_scalar(b1, gn), now.to(torch.float32))
    bc2 = 1 - torch.pow(_scalar(b2, gn), now.to(torch.float32))
    lr = lr_fn(now - 1)
    g_leaves = dict(prm.leaf_paths(grads))
    m_leaves = dict(prm.leaf_paths(state.m))
    v_leaves = dict(prm.leaf_paths(state.v))
    for path, p in prm.leaf_paths(params):
        for pc, gc, mc, vc in zip(*(_chunks(t) for t in (
                p, g_leaves[path], m_leaves[path], v_leaves[path]))):
            gc.mul_(scale)
            mc.mul_(b1).add_(gc * (1 - b1))
            vc.mul_(b2).add_(torch.square(gc).mul_(1 - b2))
            u = (mc / bc1).div_(torch.sqrt(vc / bc2).add_(eps))
            u.add_(weight_decay * pc)
            pc.sub_(u.mul_(lr))
    return params, AdamWState(step, state.m, state.v), {"grad_norm": gn, "lr": lr}
