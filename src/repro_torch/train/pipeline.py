"""Pipeline parallelism — GPipe-style micro-batch pipelining (PyTorch port
of `repro/train/pipeline.py`).

Each stage holds a contiguous share of the layer groups. The schedule is
JAX's loop-pipeline: steps = M + n_stages − 1; stage s works on
micro-batch t − s at step t, every stage computes at every step, and
validity masks keep the fill/drain bubbles out of the loss. Activations
flow stage → stage (cyclic; the hand-off into stage 0 is unused), and the
last stage's mean loss is shared with every stage.

Placement (JAX's mesh axis has no torch object), as the shard-parallel
search's (core/distributed.py):
- `devices=[d0, d1, ...]`, in one process: stage s runs on devices[s]
  (a device may repeat); activations move with `.to`, and autograd
  carries the gradients back along the same moves;
- `group=`, under torch.distributed: rank r is stage r and passes its own
  stage's block of the stacked parameters (`local_stage` cuts it). The
  hand-off is `collectives.shift` (send to the next rank, receive from
  the previous; its backward sends the gradient back), and the loss is
  shared by `collectives.sum_shared`, JAX's `psum`.
Under `group=` every stage computes the head and a masked loss at every
step, as JAX's program does: the masked terms (0) tie each rank's loss to
every hand-off, so each rank's backward pass runs every `shift` in the
same order as its neighbours'. In one process only the last stage
computes them (the masked terms are 0 and autograd needs no tie).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch import collectives
from repro_torch.models import params as prm
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import DTYPES, matmul_w, rmsnorm, softmax_xent


def stack_stage_params(params, cfg: ModelConfig, n_stages: int = 2):
    """Split the group stack into per-stage shares and stack EVERYTHING
    over a leading stage dim. Non-group params (embed/head/final_norm) are
    repeated per stage (broadcast views); only stage 0 uses embed, only the
    last stage uses head/final_norm."""
    G = cfg.n_groups
    if G % n_stages:
        raise ValueError(f"{G} groups do not split into {n_stages} stages")
    per = G // n_stages
    stacked = {"groups": prm.tree_map(
        lambda a: a.reshape((n_stages, per) + tuple(a.shape[1:])), params["groups"])}
    for key in ("final_norm", "head", "embed"):
        stacked[key] = prm.tree_map(
            lambda a: a.expand((n_stages,) + tuple(a.shape)), params[key])
    return stacked


def local_stage(stage_params, group):
    """This rank's stage of a stacked stage tree: the (1, ...) block at its
    rank (a copy, contiguous)."""
    r = dist.get_rank(group)
    return prm.tree_map(lambda a: a[r:r + 1].contiguous(), stage_params)


def _stage_forward(groups, x, cfg: ModelConfig):
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device).expand(x.shape[:2])
    n = next(iter(prm.leaf_paths(groups)))[1].shape[0]
    for gp in T._unstack(groups, n):
        x, _ = T._apply_group(gp, x, positions, cfg, "causal", None, None)
    return x


def _stage_loss(sp, y, lbl, cfg: ModelConfig):
    h = rmsnorm(sp["final_norm"], y, cfg.norm_eps)
    return torch.mean(softmax_xent(matmul_w(h, sp["head"]["w"]), lbl, cfg.vocab_size))


def make_pipelined_loss(cfg: ModelConfig, n_stages: int = 2, *,
                        devices: Optional[Sequence] = None, group=None):
    """Returns fn(stage_params, tokens, labels) → mean loss (f32 0-d).

    tokens/labels: (M, micro_B, S) — M micro-batches. stage_params: the
    stacked tree of `stack_stage_params`, or under `group=` this rank's
    (1, ...) block of it.
    """
    if (devices is None) == (group is None):
        raise ValueError("pass exactly one of devices= and group=")
    if group is not None and dist.get_world_size(group) != n_stages:
        raise ValueError(f"a group of {dist.get_world_size(group)} ranks for "
                         f"{n_stages} stages")
    dt = DTYPES[cfg.compute_dtype]

    def valid_of(t: int, M: int, last: bool) -> float:
        """1 where the last stage holds a real micro-batch at step t."""
        return float(last and 0 <= t - (n_stages - 1) < M)

    def mb_of(t: int, M: int) -> int:
        return min(max(t - (n_stages - 1), 0), M - 1)

    def in_process(stage_params, tokens, labels):
        M = tokens.shape[0]
        devs = [torch.device(devices[s % len(devices)]) for s in range(n_stages)]
        sp = [prm.tree_map(lambda a: a[s].to(devs[s]), stage_params)
              for s in range(n_stages)]
        recv = [torch.zeros(tokens.shape[1:] + (cfg.d_model,), dtype=dt, device=devs[s])
                for s in range(n_stages)]
        loss_sum = torch.zeros((), device=devs[-1])
        n_loss = torch.zeros((), device=devs[-1])
        for t in range(M + n_stages - 1):
            ys = []
            for s in range(n_stages):
                x_in = (T.embed(sp[0]["embed"], tokens[min(t, M - 1)].to(devs[0]), cfg)
                        if s == 0 else recv[s])
                ys.append(_stage_forward(sp[s]["groups"], x_in.to(dt), cfg))
            valid = valid_of(t, M, True)
            loss_sum = loss_sum + valid * _stage_loss(
                sp[-1], ys[-1], labels[mb_of(t, M)].to(devs[-1]), cfg)
            n_loss = n_loss + valid
            recv = [ys[s - 1].to(devs[s]) for s in range(n_stages)]
        return loss_sum / torch.clamp(n_loss, min=1.0)

    def ranked(stage_params, tokens, labels):
        sp = prm.tree_map(lambda a: a[0], stage_params)
        stage = dist.get_rank(group)
        dev = sp["final_norm"]["scale"].device
        M, mb, S = tokens.shape
        tokens, labels = tokens.to(dev), labels.to(dev)
        recv = torch.zeros((mb, S, cfg.d_model), dtype=dt, device=dev)
        first = torch.tensor(stage == 0, device=dev)
        loss_sum = torch.zeros((), device=dev)
        n_loss = torch.zeros((), device=dev)
        steps = M + n_stages - 1
        for t in range(steps):
            x0 = T.embed(sp["embed"], tokens[min(t, M - 1)], cfg)
            y = _stage_forward(sp["groups"], torch.where(first, x0.to(dt), recv.to(dt)), cfg)
            valid = valid_of(t, M, stage == n_stages - 1)
            loss_sum = loss_sum + valid * _stage_loss(sp, y, labels[mb_of(t, M)], cfg)
            n_loss = n_loss + valid
            if t < steps - 1:          # the last hand-off is read by no one
                recv = collectives.shift(y, group)
        total = collectives.sum_shared(loss_sum, group)
        dist.all_reduce(n_loss, group=group)
        return total / torch.clamp(n_loss, min=1.0)

    return in_process if group is None else ranked


def pipelined_loss_and_grad(cfg: ModelConfig, stage_params, tokens, labels,
                            n_stages: int = 2, *, devices: Optional[Sequence] = None,
                            group=None):
    """(loss, gradients of the loss as a tree like stage_params)."""
    fn = make_pipelined_loss(cfg, n_stages, devices=devices, group=group)
    leaves = prm.tree_map(lambda a: a.detach().requires_grad_(), stage_params)
    flat = [t for _, t in prm.leaf_paths(leaves)]
    loss = fn(leaves, tokens, labels)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    by_leaf = {id(t): (torch.zeros_like(t) if g is None else g) for t, g in zip(flat, grads)}
    return loss.detach(), prm.tree_map(lambda t: by_leaf[id(t)], leaves)
