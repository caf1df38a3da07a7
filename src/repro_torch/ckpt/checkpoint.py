"""Atomic, retention-managed checkpointing (PyTorch port of
`repro/ckpt/checkpoint.py`).

Format (JAX's, so a checkpoint written by either package opens in the
other bit for bit): one `leaves.npz` with the flattened leaves keyed by
their tree path, plus `meta.json` (step, leaf names, dtypes, extra). A
leaf's name is JAX's `keystr` of its path — `['key']` for a dict key,
`.field` for a NamedTuple field, `[i]` for a list or tuple item — with
anything outside [A-Za-z0-9_.-] replaced by `_`; leaves come in JAX's
order (dict keys sorted, NamedTuple fields in order) and None holds no
leaf. bf16 leaves are stored as a uint16 view with "bfloat16" in
`dtypes`. Saves go to a tmp dir, then through the rename-aside swap
(`atomic_replace_dir`), so a preempted save never loses the latest
committed checkpoint.

`restore(path, template, device=None)` rebuilds `template`'s structure
(its leaves may be meta tensors) with the file's dtypes on `device`:
CUDA unless the caller asks for the CPU. It takes the place of JAX's
`shardings=`: a checkpoint written on one device restores onto any other.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.ckpt.index_store import atomic_replace_dir, resolve_snapshot_dir
from repro_torch.utils import Device, resolve_device


def _flatten(tree, path: str = ""):
    """(JAX keystr path, leaf) pairs in JAX's flattening order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _flatten(getattr(tree, f), f"{path}.{f}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{path}[{i}]")
    else:
        yield path, tree


def _unflatten(template, leaves):
    """`template`'s structure with its leaves taken in order from `leaves`."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_unflatten(getattr(template, f), leaves)
                                for f in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def _leaf_names(tree):
    names = [re.sub(r"[^A-Za-z0-9_.\-]", "_", p) for p, _ in _flatten(tree)]
    if len(set(names)) != len(names):
        raise ValueError("non-unique leaf names")
    return names


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:      # numpy has no bfloat16
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def save(path: str, tree: Any, step: int = 0, extra: Optional[dict] = None):
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    names = _leaf_names(tree)
    arrays = {}
    dtypes = {}
    for n, (_, leaf) in zip(names, _flatten(tree)):
        bf16 = isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
        a = _to_numpy(leaf)
        dtypes[n] = "bfloat16" if bf16 else str(a.dtype)
        arrays[n] = a
    np.savez(os.path.join(tmp, "leaves.npz"), **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "names": names, "dtypes": dtypes,
                   "extra": extra or {}}, f)
        f.flush()
        os.fsync(f.fileno())
    atomic_replace_dir(tmp, path)


def restore(path: str, template: Any, device: Device = None):
    """Rebuild `template`'s tree from disk on `device` → (tree, step, extra)."""
    dev = resolve_device(device)
    path = resolve_snapshot_dir(path)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint directory at {path}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    names = _leaf_names(template)
    if names != meta["names"]:
        raise ValueError("checkpoint/template structure mismatch")
    leaves = []
    with np.load(os.path.join(path, "leaves.npz")) as data:
        for n in names:
            a = data[n]
            if meta.get("dtypes", {}).get(n) == "bfloat16":
                t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(a)
            leaves.append(t.to(dev))
    return _unflatten(template, iter(leaves)), meta["step"], meta["extra"]


class CheckpointManager:
    """step-numbered checkpoints under a directory, keeping the newest N."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        # retention must never delete the checkpoint that was just
        # written — keep < 1 would do exactly that
        self.keep = max(1, int(keep))
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}")

    def steps(self):
        """Committed steps, sorted. Stray entries (foo/, ckpt_abc,
        ckpt_N.tmp) are ignored; a checkpoint surviving only as
        ckpt_N.old (crash mid-swap) counts — restore() finishes the
        swap."""
        out = set()
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"ckpt_(\d+)(\.old)?", name)
            if m:
                out.add(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def save(self, step: int, tree, extra=None):
        save(self._path(step), tree, step=step, extra=extra)
        for old in self.steps()[:-self.keep]:
            if old == step:      # an out-of-order save of an old step is
                continue         # still the newest write — never drop it
            for p in (self._path(old), self._path(old) + ".old"):
                if os.path.isdir(p):
                    shutil.rmtree(p)

    def restore(self, template, step: Optional[int] = None, device: Device = None):
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints under {self.dir}")
        elif step not in self.steps():
            have = self.steps()
            raise FileNotFoundError(
                f"no checkpoint for step {step} under {self.dir} "
                f"(have steps {have})" if have else
                f"no checkpoint for step {step} under {self.dir} "
                f"(directory is empty)")
        return restore(self._path(step), template, device)

    # -------- train-state convenience (params + optimizer + data cursor)
    def save_train_state(self, step: int, params, opt_state):
        self.save(step, {"params": params, "opt": opt_state},
                  extra={"data_step": step})

    def restore_train_state(self, cfg, device: Device = None):
        from repro_torch.models import transformer as T
        from repro_torch.train import optimizer as opt
        params_t = T.abstract_params(cfg)
        tmpl = {"params": params_t,
                "opt": opt.AdamWState(torch.empty((), dtype=torch.int32, device="meta"),
                                      params_t, params_t)}
        tree, step, extra = self.restore(tmpl, self.latest_step(), device)
        return tree["params"], tree["opt"], extra.get("data_step", step)
