"""Training step factory + training loop (PyTorch port of
`repro/train/train_loop.py`).

- Gradient accumulation: the global batch is split into `accum`
  micro-batches, run in order; autograd adds each one's gradient into the
  step's gradient tree, which is then divided by `accum` (JAX sums from
  zeros in the same order, then divides).
- Memory: the gradient tree is allocated once a step, and each group
  slice of a stacked leaf is its own autograd leaf whose `.grad` is that
  slice of the tree, so a group's gradient is added in place as soon as
  its backward pass is done. With `cfg.remat == "block"` only each
  group's input is kept between the passes (models/transformer.py).
- The step updates params and the optimizer state in place (the JAX step
  donates them) and returns them.
- Fault tolerance: CheckpointManager integration, preemption-safe saves
  (SIGTERM → save-and-exit), step watchdog (straggler surfacing), and
  deterministic data resume from the step counter alone.

Departure: where no parameters are given, `train` draws them from
`init_params(torch.Generator().manual_seed(seed))`, the port's init, not
JAX's `PRNGKey` stream.
"""
from __future__ import annotations

import signal
import time
from typing import Callable, Optional

import torch

from repro_torch.models import params as prm
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer as opt
from repro_torch.utils import Device, resolve_device


def _zip_map(fn, a, b):
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def _leaf(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """An alias of p that autograd accumulates into g, in place."""
    v = p.detach().requires_grad_()
    v.grad = g
    return v


def _grad_leaves(params: dict, grads: dict, n_groups: int) -> dict:
    """The parameter tree as autograd leaves accumulating into `grads`:
    the group stacks as a list of per-group trees of slices."""
    out = {k: _zip_map(_leaf, v, grads[k]) for k, v in params.items() if k != "groups"}
    out["groups"] = [_zip_map(lambda p, g: _leaf(p[gi], g[gi]),
                              params["groups"], grads["groups"])
                     for gi in range(n_groups)]
    return out


def make_train_step(cfg: ModelConfig, lr_fn, accum: int = 1,
                    weight_decay: float = 0.1, clip_norm: float = 1.0):
    """Returns fn(params, opt_state, batch) → (params, state, metrics), the
    batch a dict of tensors on the parameters' device."""

    def step_fn(params, opt_state, batch):
        grads = prm.tree_map(torch.zeros_like, params)
        leaves = _grad_leaves(params, grads, cfg.n_groups)
        if accum == 1:
            loss = T.loss_fn(leaves, batch, cfg)
            loss.backward()
            loss = loss.detach()
        else:
            first = next(iter(batch.values()))
            B = first.shape[0]
            if B % accum:
                raise ValueError(f"batch {B} does not split into {accum} micro-batches")
            mb = B // accum
            loss = torch.zeros((), dtype=torch.float32, device=first.device)
            for i in range(accum):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                lm = T.loss_fn(leaves, micro, cfg)
                lm.backward()
                loss = loss + lm.detach()
            n = torch.full((), float(accum), device=first.device)   # a true division on CUDA too
            loss = loss / n
            for _, g in prm.leaf_paths(grads):
                g.div_(n)
        del leaves
        params, opt_state, metrics = opt.update(
            grads, opt_state, params, lr_fn,
            weight_decay=weight_decay, clip_norm=clip_norm)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step_fn


class Watchdog:
    """Surfaces straggling steps (the single-process analogue of per-host
    heartbeat monitoring): if a step exceeds `factor`× the running median,
    it is logged; the callback can trigger checkpoint+respawn at scale."""

    def __init__(self, factor: float = 3.0, warn=print):
        self.durations = []
        self.factor = factor
        self.warn = warn

    def observe(self, dt: float, step: int):
        if len(self.durations) >= 5:
            med = sorted(self.durations)[len(self.durations) // 2]
            if dt > self.factor * med:
                self.warn(f"[watchdog] step {step} took {dt:.2f}s "
                          f"(median {med:.2f}s) — straggler suspected")
        self.durations.append(dt)
        if len(self.durations) > 100:
            self.durations.pop(0)


def train(cfg: ModelConfig, pipeline, steps: int, lr: float = 3e-4,
          accum: int = 1, ckpt_manager=None, ckpt_every: int = 100,
          log_every: int = 10, params=None, seed: int = 0,
          on_log: Optional[Callable] = None, device: Device = None):
    """End-to-end training loop (used by launch/train.py) on `device`: CUDA
    unless the caller asks for the CPU. Resumes from `ckpt_manager`'s
    latest checkpoint when it has one; batches come from
    `pipeline.batch_at(step)` and are moved to the device."""
    dev = resolve_device(device)
    lr_fn = opt.warmup_cosine(lr, warmup=max(steps // 20, 10), total=steps)
    step_fn = make_train_step(cfg, lr_fn, accum=accum)

    start_step = 0
    opt_state = None
    if ckpt_manager is not None and ckpt_manager.latest_step() is not None:
        params, opt_state, start_step = ckpt_manager.restore_train_state(cfg, device=dev)
        print(f"[train] resumed from step {start_step}")
    if params is None:
        params = T.init_params(torch.Generator().manual_seed(seed), cfg, device=dev)
    params = prm.tree_map(lambda a: a.to(dev), params)
    if opt_state is None:
        opt_state = opt.init(params)

    preempted = {"flag": False}

    def _on_term(sig, frame):
        preempted["flag"] = True
    try:
        signal.signal(signal.SIGTERM, _on_term)
    except ValueError:
        pass   # non-main thread (tests)

    wd = Watchdog()
    losses = []
    for step in range(start_step, steps):
        t0 = time.time()
        batch = {k: v.to(dev) for k, v in pipeline.batch_at(step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        dt = time.time() - t0
        wd.observe(dt, step)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % log_every == 0 or step == steps - 1:
            msg = (f"step {step:5d} loss {loss:.4f} "
                   f"gnorm {float(metrics['grad_norm']):.3f} "
                   f"lr {float(metrics['lr']):.2e} {dt:.2f}s")
            print(msg)
            if on_log:
                on_log(step, metrics)
        should_ckpt = (ckpt_manager is not None
                       and (step % ckpt_every == 0 or step == steps - 1
                            or preempted["flag"]))
        if should_ckpt:
            ckpt_manager.save_train_state(step + 1, params, opt_state)
        if preempted["flag"]:
            print(f"[train] preemption signal → saved at step {step}, exiting")
            break
    return params, opt_state, losses
