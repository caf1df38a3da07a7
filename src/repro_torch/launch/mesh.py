"""Production meshes + logical→physical sharding rules (PyTorch port of
`repro/launch/mesh.py`).

JAX's model is one logical program plus per-axis rules that GSPMD
partitions. The port runs the same eager program on DTensors
(`torch.distributed.tensor`) over a `DeviceMesh` whose dim names are
JAX's mesh axes ("pod", "data", "model"): a logical axis maps through the
rules to mesh dims, and a spec (one entry a tensor dim: None, a mesh dim
name, or a tuple of them) maps to DTensor placements with
`to_placements`.

Importing this module touches no process group; meshes are built inside
functions only.

Uneven dims: JAX's `NamedSharding.shard_shape` refuses a dim that does
not divide its mesh axes (a `device_put` onto it pads each shard to
ceil(n/k)). `Shard`'s placement follows `torch.chunk`: ceil(n/k) rows a
rank, the last ranks short or empty. The rules of every config divide
every dim they shard at both production meshes (tests/test_torch_sharding.py
holds each leaf's local shape against JAX's), so the two never meet there.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

@contextlib.contextmanager
def set_mesh(mesh: DeviceMesh) -> Iterator[DeviceMesh]:
    """Make `mesh` the ambient mesh for the following block.

    Inside it a plain tensor that meets a DTensor is taken as replicated
    on the DTensor's mesh (DTensor's `implicit_replication`), as JAX takes
    an array with no sharding under its ambient mesh: the masks, position
    ids and zeros the model builds stay plain tensors, the same on every
    rank. A mesh of CUDA tensors over gloo stages DTensor's collectives
    through host copies (`collectives.host_staged_collectives`)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.collectives import host_staged_collectives

    staged = mesh.device_type == "cuda" and dist.get_backend(mesh.get_group(0)) == "gloo"
    with implicit_replication(), \
            (host_staged_collectives() if staged else contextlib.nullcontext()):
        yield mesh


def _mesh_dims(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def to_placements(mesh: DeviceMesh, spec) -> tuple:
    """A spec (one entry a tensor dim: None, a mesh dim name, or a tuple
    of names sharding that dim major to minor, as `P(("pod", "data"))`)
    → one placement a mesh dim: `Shard(tensor dim)` where a tensor dim
    maps to it, `Replicate()` otherwise (JAX's `to_shardings`)."""
    names = mesh.mesh_dim_names
    out = [Replicate()] * mesh.ndim
    for tdim, entry in enumerate(spec):
        dims = _mesh_dims(entry)
        idx = [names.index(n) for n in dims]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: {dims} shard dim {tdim} minor to major; "
                             f"DTensor shards a dim over mesh dims in mesh order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: mesh dim {names[i]!r} used twice")
            out[i] = Shard(tdim)
    return tuple(out)


def local_range(shape, mesh: DeviceMesh, placements) -> tuple:
    """This rank's (offsets, sizes) of a tensor of `shape` under
    `placements` (`Shard`'s `torch.chunk` rule, mesh dims that shard one
    tensor dim nesting major to minor), in plain Python: no tensor op, so
    nothing of it reaches a dispatch mode. A rank outside the mesh holds
    nothing: zero offsets and sizes."""
    coord = mesh.get_coordinate()
    if coord is None:
        return (0,) * len(shape), (0,) * len(shape)
    off, size = [0] * len(shape), list(shape)
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            k, r = mesh.size(m), coord[m]
            chunk = -(-size[p.dim] // k)
            lo = min(r * chunk, size[p.dim])
            off[p.dim] += lo
            size[p.dim] = min(chunk, size[p.dim] - lo)
    return tuple(off), tuple(size)


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _first_ranks(shape, axes, device_type: Optional[str]) -> DeviceMesh:
    """A mesh of `shape` over ranks 0 .. prod(shape) − 1 of the default
    process group, row-major, as JAX takes its first devices. Every rank
    of the group builds it (it makes subgroups, a collective); a rank past
    the mesh gets `get_coordinate() is None` and empty local shards."""
    shape, n = tuple(shape), math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n:
        raise RuntimeError(f"need {n} devices for mesh {shape}; have {world} — "
                           f"start {n} ranks (torchrun --nproc-per-node ... "
                           f"--nnodes ...) before building the mesh")
    return DeviceMesh(device_type or _device_type(), torch.arange(n).view(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """(16, 16) ("data", "model"), or (2, 16, 16) with "pod", over the
    first 256 or 512 ranks of the default process group in row-major
    order, as JAX's takes its first 256 or 512 devices. Fewer ranks than
    that are refused (JAX asserts its device count); ranks past them sit
    outside the mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _first_ranks(shape, axes, device_type)


def make_test_mesh(shape=(2, 4), axes=("data", "model"),
                   device_type: Optional[str] = None) -> DeviceMesh:
    """Small mesh over the first prod(shape) ranks of the default process
    group, as JAX's takes its first prod(shape) devices."""
    return _first_ranks(shape, axes, device_type)


# --------------------------------------------------------------------------
# Logical axis rules (DESIGN.md §6)
# --------------------------------------------------------------------------

BASE_RULES = {
    # parameters: FSDP over "data" on the embed dim, TP over "model"
    "embed": "data",
    "mlp": "model",
    "heads": "model",
    "head": None,
    "kv_heads": None,
    "vocab": "model",
    "expert": "model",
    "expert_mlp": None,
    "shead": "model",     # sLSTM (head × block) sub-heads
    # activations
    "batch": "data",
    "act_embed": None,
    "kv_seq": "model",
}


def build_rules(arch_overrides: dict | None = None, *, multi_pod: bool = False,
                batch_size: int | None = None, dp_degree: int = 16) -> dict:
    """Resolve the rule set for one (arch × shape × mesh) cell.

    - multi-pod: batch additionally shards over the outer "pod" axis.
    - batch=1 cells (long_500k): batch unshardable → the KV seq dim takes
      ALL mesh axes instead (524288/512 = 1024 rows per chip).
    """
    rules = dict(BASE_RULES)
    if multi_pod:
        rules["batch"] = ("pod", "data")
    if arch_overrides:
        rules.update(arch_overrides)
    if batch_size is not None:
        dp = dp_degree * (2 if multi_pod else 1)
        if batch_size < dp:
            rules["batch"] = None
            rules["kv_seq"] = (("pod", "data", "model") if multi_pod
                               else ("data", "model"))
    return rules


def device_of(mesh: DeviceMesh) -> torch.device:
    """The device a mesh's local shards live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
