"""Minimal parameter-definition system (PyTorch port of
`repro/models/params.py`): each leaf carries a shape, logical axis names
and an init scale. Three materializations:

- `abstract(defs)` → meta-device tensors (shapes and dtypes, no memory)
- `init(generator, defs)` → real tensors, each leaf from its own generator
- `pspecs(defs, rules)` → one spec a leaf: a tuple with one mesh-axis
  entry a dim (JAX's PartitionSpec as a tuple), which `distribute` turns
  into DTensor placements on a mesh (`launch/mesh.py`)

The init rules are JAX's, not its bits: `zeros`, `ones` and `ssm_a` give
the same values; `normal` draws from torch's generator with JAX's std.
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


def pspecs(defs, rules: dict):
    """One spec a leaf: each dim's logical axis through `rules`."""
    return tree_map(lambda d: spec_of(d.axes, rules), defs, _is_def)


def spec_of(axes, rules: dict) -> tuple:
    """Logical axis names (None = replicated) → mesh-axis entries."""
    return tuple(rules.get(a) if a is not None else None for a in axes)


def distribute(tree, specs, mesh):
    """A tree of tensors → DTensors on `mesh`, leaf by leaf under the spec
    tree (`pspecs`, `transformer.cache_pspecs`). Every rank passes the
    same whole tensors and keeps its own shard of each (no collective);
    a meta tensor gives a meta shard, which is how the dry run places
    parameters it never allocates. A leaf already a DTensor is
    redistributed."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import local_range, to_placements

    def place(t, spec):
        pl = to_placements(mesh, spec)
        if isinstance(t, DTensor):
            return t.redistribute(mesh, pl)
        off, shape = local_range(t.shape, mesh, pl)
        # a copy, so the shard does not keep the whole tensor's storage
        local = t.detach()[tuple(slice(o, o + n) for o, n in zip(off, shape))].clone(
            memory_format=torch.contiguous_format)
        stride = [1] * t.dim()
        for i in range(t.dim() - 2, -1, -1):
            stride[i] = stride[i + 1] * t.shape[i + 1]
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape, stride=tuple(stride))
    return tree_zip(place, tree, specs)


def tree_zip(fn, tree, other):
    """fn(leaf, other's leaf) over a tree and a spec tree of its shape."""
    if isinstance(tree, dict):
        return {k: tree_zip(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_zip(fn, a, b) for a, b in zip(tree, other)))
    return fn(tree, other)


def logical_shapes(defs):
    return tree_map(lambda d: d.shape, defs, _is_def)
