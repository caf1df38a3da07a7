"""Training step factory + training loop (PyTorch port of
`repro/train/train_loop.py`).

- Gradient accumulation: the global batch is split into `accum`
  micro-batches, run in order; autograd adds each one's gradient into the
  step's gradient tree, which is then divided by `accum` (JAX sums from
  zeros in the same order, then divides). On a mesh (the parameters and
  the batch DTensors, `models/params.distribute`) micro-batch i is the
  i-th share of every data rank's own rows, so no row moves; JAX's is
  the i-th run of contiguous global rows, which GSPMD reshards. Every
  micro-batch has the same size, so the loss and gradients are the same
  sums in another order.
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

import contextlib
import signal
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.launch.mesh import device_of, set_mesh
from repro_torch.models.layers import get_logical_rules
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


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _micro(v: torch.Tensor, i: int, accum: int) -> torch.Tensor:
    """Micro-batch i of accum: rows [i·B/accum, (i+1)·B/accum) of v, or of
    each rank's rows of a DTensor batch (which stay where they are)."""
    loc = _local(v)
    n = loc.shape[0] // accum
    part = loc[i * n:(i + 1) * n]
    if isinstance(v, DTensor):
        return DTensor.from_local(part, v.device_mesh, v.placements, run_check=False)
    return part


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
            B = _local(first).shape[0]
            if B % accum:
                raise ValueError(f"batch {B} does not split into {accum} micro-batches")
            loss = torch.zeros((), dtype=torch.float32, device=first.device)
            for i in range(accum):
                micro = {k: _micro(v, i, accum) for k, v in batch.items()}
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
          on_log: Optional[Callable] = None, device: Device = None, mesh=None):
    """End-to-end training loop (used by launch/train.py) on `device`: CUDA
    unless the caller asks for the CPU. Resumes from `ckpt_manager`'s
    latest checkpoint when it has one; batches come from
    `pipeline.batch_at(step)` and are moved to the device.

    With `mesh` (a `DeviceMesh` over the first ranks of the process group,
    the logical rules set: `launch/train.py --mesh`), the parameters,
    optimizer state and each batch are placed on it by the rules (FSDP +
    TP), every rank of the mesh runs the same loop (a rank past it does not
    call `train`), and checkpoints are gathered whole and written by rank 0
    (JAX's format holds whole arrays)."""
    dev = resolve_device(device) if mesh is None else device_of(mesh)
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
    ctx = contextlib.nullcontext()
    if mesh is not None:
        rules = get_logical_rules()
        pspecs = T.param_pspecs(cfg, rules)
        params = prm.distribute(params, pspecs, mesh)
        if opt_state is not None:
            opt_state = opt.AdamWState(opt_state.step.to(dev),
                                       prm.distribute(opt_state.m, pspecs, mesh),
                                       prm.distribute(opt_state.v, pspecs, mesh))
        ctx = set_mesh(mesh)
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
    with ctx:
        for step in range(start_step, steps):
            t0 = time.time()
            batch = {k: v.to(dev) for k, v in pipeline.batch_at(step).items()}
            if mesh is not None:
                b = get_logical_rules().get("batch")
                batch = prm.distribute(batch, {k: (b,) + (None,) * (v.dim() - 1)
                                               for k, v in batch.items()}, mesh)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            dt = time.time() - t0
            wd.observe(dt, step)
            loss = float(_whole(metrics["loss"]))
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
                _save(ckpt_manager, step + 1, params, opt_state, mesh)
            if preempted["flag"]:
                print(f"[train] preemption signal → saved at step {step}, exiting")
                break
    return params, opt_state, losses


def _whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def _save(mgr, step: int, params, opt_state, mesh) -> None:
    if mesh is None:
        mgr.save_train_state(step, params, opt_state)
        return
    params = prm.tree_map(_whole, params)         # a collective on every rank
    opt_state = opt.AdamWState(_whole(opt_state.step), prm.tree_map(_whole, opt_state.m),
                               prm.tree_map(_whole, opt_state.v))
    if dist.get_rank() == 0:
        mgr.save_train_state(step, params, opt_state)
    _mesh_barrier(mesh)


def _mesh_barrier(mesh) -> None:
    """A barrier over the mesh's ranks alone: ranks of the process group
    past the mesh may have left it (launch/train.py). One barrier over each
    mesh dim's group in turn: after dim d's, a rank knows that every rank
    differing from it in dims 0..d only has arrived, so after the last, all."""
    for d in range(mesh.ndim):
        dist.barrier(group=mesh.get_group(d))
