"""Minimal parameter-definition system (PyTorch port of
`repro/models/params.py`): each leaf carries a shape, logical axis names
and an init scale. Two materializations:

- `abstract(defs)` → meta-device tensors (shapes and dtypes, no memory)
- `init(generator, defs)` → real tensors, each leaf from its own generator

The init rules are JAX's, not its bits: `zeros`, `ones` and `ssm_a` give
the same values; `normal` draws from torch's generator with JAX's std.
The logical axes are kept as data: the port has no PartitionSpecs.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.utils import Device, resolve_device


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]      # logical axis name per dim (None = replicated)
    init: str = "normal"                 # "normal" | "zeros" | "ones" | "ssm_a"
    scale: float = 1.0                   # stddev multiplier (normal), fan-in applied

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map(fn, tree, is_leaf=lambda x: not isinstance(x, (dict, tuple))):
    """fn over the leaves of nested dicts and (named) tuples."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    vals = [tree_map(fn, v, is_leaf) for v in tree]
    return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)


def _is_def(x):
    return isinstance(x, ParamDef)


def leaf_paths(tree, prefix: str = ""):
    """(JAX keystr path, leaf) pairs of a nested dict, in JAX's (sorted)
    flattening order: "['groups']['pos0_attn']['wq']"."""
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from leaf_paths(tree[k], f"{prefix}[{k!r}]")


def abstract(defs, dtype=torch.float32):
    return tree_map(lambda d: torch.empty(d.shape, dtype=dtype, device="meta"),
                    defs, _is_def)


def _fan_in_std(d: ParamDef) -> float:
    fan_in = d.shape[0] if len(d.shape) >= 2 else max(d.shape[0], 1)
    if len(d.shape) >= 3:                # stacked (group) leading dim
        fan_in = d.shape[1]
    return d.scale / math.sqrt(max(fan_in, 1))


def init(generator: torch.Generator, defs, dtype=torch.float32,
         device: Device = None):
    """Deterministic per-leaf init: each leaf draws from its own generator,
    seeded from `generator`'s seed and the md5 of the leaf's path, so a
    leaf's values do not depend on which other leaves exist."""
    dev = resolve_device(device)
    base = generator.initial_seed() % (1 << 31)
    out = {}
    for tag, d in leaf_paths(defs):
        if d.init == "zeros":
            t = torch.zeros(d.shape, dtype=dtype, device=dev)
        elif d.init == "ones":
            t = torch.ones(d.shape, dtype=dtype, device=dev)
        elif d.init == "ssm_a":
            # mamba A init: log(1..N) over the state dim (last axis),
            # stored as log(-A); A = -exp(.)
            n = d.shape[-1]
            a = torch.arange(1, n + 1, dtype=dtype, device=dev)
            t = torch.log(a).expand(d.shape).contiguous()
        else:
            h = int.from_bytes(hashlib.md5(tag.encode()).digest()[:4], "little")
            g = torch.Generator(device=dev).manual_seed((base << 32) | h)
            t = torch.randn(d.shape, generator=g, dtype=dtype, device=dev)
            t.mul_(_fan_in_std(d))
        out[tag] = t
    return _unflatten(defs, out)


def _unflatten(defs, flat: dict, prefix: str = ""):
    if not isinstance(defs, dict):
        return flat[prefix]
    return {k: _unflatten(v, flat, f"{prefix}[{k!r}]") for k, v in defs.items()}


def logical_shapes(defs):
    return tree_map(lambda d: d.shape, defs, _is_def)
