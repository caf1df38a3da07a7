"""Op-counting analysis of one PyTorch call (PyTorch port of
`repro/launch/hlo_analysis.py`): the three roofline inputs, counted from
the aten and c10d ops the call dispatches.

JAX asks XLA for the compiled per-device program and walks its HLO. Torch
has no compiler to ask, so `analyze` runs the call itself under
`OpCounter`, a `TorchDispatchMode` that sees every op. On tensors of the
"meta" device (shapes and dtypes, no storage) the call computes nothing,
so a program far larger than this machine can be counted here; the
kernels' wrappers report their own work on meta (`kernels/_build.report`).

- **Product FLOPs**: every op of `torch.utils.flop_counter`'s registry
  (`mm`, `addmm`, `bmm`, `baddbmm`, convolutions, attention), 2·out·
  contraction for a product, which is what `einsum` and `matmul`
  decompose into, plus what the kernels report. Kept per dtype
  (`flops_by_dtype`), so a roofline divides each by its own peak.
- **HBM bytes**: per op, the distinct input storages read (each input's
  own elements; a gather's source counts only the elements it gathers,
  as JAX charges a slice) plus the outputs written. A view writes
  nothing and counts 0; an allocation (`empty`) moves nothing.
- **Collectives**: output bytes of every c10d collective, as JAX counts
  output-shape bytes, under JAX's names (`all-gather`, ...).
- **Temp bytes**: every storage an op creates is live from then until it
  is freed (a `weakref.finalize` on the storage, each counted once);
  `temp_bytes` is the high-water mark of the live bytes, the counterpart
  of XLA's `temp_size_in_bytes`. The call's arguments are not temp.

DTensors (the LM's sharded program, `launch/dryrun.py`): the counter
declines an op on DTensors (`NotImplemented`), so DTensor's dispatch runs
it: the ops it runs on the local shards and the collectives it issues
(`_c10d_functional`) come back to the counter, and are counted at this
device's shapes — the per-device program, as JAX's HLO is. The ops
DTensor's sharding propagation runs on fake tensors at global shapes
(to derive an output's metadata) are not counted. Arguments and
outputs that are DTensors count their local shards.

Trip counts need no recovery: a Python loop dispatches its body on
every iteration, so each op is counted as often as it runs, exactly.

Departure from JAX: the bytes are eager and unfused. XLA charges a
fusion's boundary; here every op reads and writes device memory, so
`hbm_bytes` is an upper bound on what the same program would move fused,
and `temp_bytes` holds what eager execution keeps alive, not XLA's
buffer assignment.
"""
from __future__ import annotations

import time
import weakref
from collections import defaultdict
from typing import Callable, Dict, List

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis.contracts import host_sync

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# c10d ops (process-group and functional forms) under JAX's collective names
_C10D_NAMES = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
_C10D_NAMESPACES = ("c10d", "_c10d_functional")
_NOT_DATA = {"barrier", "monitored_barrier_", "wait", "wait_tensor",
             "_wrap_tensor_autograd"}
_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty",
                "new_empty_strided"}
_GATHERS = {"index", "gather", "index_select", "embedding", "take"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _by_storage(tensors) -> Dict[int, int]:
    """{id of each distinct storage: the most bytes a tensor reads of it}."""
    out: Dict[int, int] = {}
    for t in tensors:
        k = id(t.untyped_storage())
        out[k] = max(out.get(k, 0), _nbytes(t))
    return out


class OpCounter(TorchDispatchMode):
    """Counts product FLOPs, HBM bytes, collectives and live storages of
    every op dispatched while it is active (module docstring). Kernels
    seen by no dispatch mode report their work through `kernel_work`."""

    def __init__(self, arguments=(), keep_contributors: bool = False) -> None:
        super().__init__()
        self.flops_by_dtype: Dict[str, float] = defaultdict(float)
        self.hbm_bytes = 0.0
        self.collectives = {c: {"count": 0.0, "bytes": 0.0} for c in COLLECTIVES}
        self.kernels: Dict[str, dict] = {}
        self.n_ops = 0
        self.host_syncs: List[str] = []
        self.live_bytes = self.temp_bytes = 0
        self._args = {id(t.untyped_storage()) for t in _tensors(arguments)}
        self._live: Dict[int, int] = {}
        self._finalizers: list = []
        self._contrib = keep_contributors
        self.hbm_by_op: Dict[tuple, list] = defaultdict(lambda: [0.0, 0])
        self.coll_by_op: Dict[tuple, list] = defaultdict(lambda: [0.0, 0])

    # -------------------------------------------------------------- events
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            # DTensor's own dispatch runs the local ops and its
            # collectives, each of which comes back here at local shapes
            return NotImplemented
        kwargs = kwargs or {}
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            # DTensor's sharding propagation deriving an output's global
            # shape on fake tensors (once an op signature): no device work
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        self.n_ops += 1
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        sync = host_sync(func, args, kwargs, out, ins, outs)
        if sync is not None:
            self.host_syncs.append(sync)
        name = func._opname
        if func.namespace in _C10D_NAMESPACES:
            self._collective(func, name, ins, outs)
        else:
            self._compute(func, name, args, kwargs, ins, outs, out)
        for t in outs:
            self._track(t.untyped_storage())
        return out

    def kernel_work(self, name: str, nbytes: float, flops: float) -> None:
        """A hand-written kernel's work, reported by its wrapper
        (`kernels/_build.report`): its bytes, its product FLOPs (f32)."""
        k = self.kernels.setdefault(name, {"calls": 0, "bytes": 0.0, "flops": 0.0})
        k["calls"] += 1
        k["bytes"] += nbytes
        k["flops"] += flops
        self.hbm_bytes += nbytes
        if flops:
            self.flops_by_dtype["float32"] += flops
        if self._contrib:
            rec = self.hbm_by_op[(f"kernel:{name}", "")]
            rec[0] += nbytes
            rec[1] += 1

    # ------------------------------------------------------------- helpers
    def _compute(self, func, name, args, kwargs, ins, outs, out) -> None:
        flop_fn = flop_registry.get(func.overloadpacket)
        if flop_fn is not None and outs:
            self.flops_by_dtype[str(outs[0].dtype).removeprefix("torch.")] += \
                flop_fn(*args, **kwargs, out_val=out)
        in_st = _by_storage(ins)
        out_st = _by_storage(outs)
        writes = any(r.alias_info is not None and r.alias_info.is_write
                     for r in func._schema.returns)
        if name in _ALLOCATIONS or (not writes and out_st.keys() <= in_st.keys()):
            return      # an allocation or a view: no bytes move
        if name in _GATHERS and ins:
            src = id(ins[0].untyped_storage())
            in_st[src] = min(in_st[src], sum(out_st.values()))
        self._add_bytes(name, sum(in_st.values()) + sum(out_st.values()), outs)

    def _collective(self, func, name, ins, outs) -> None:
        if name in _NOT_DATA:
            return
        coll = _C10D_NAMES.get(name, name)
        out_st = _by_storage(outs)
        moved = float(sum(out_st.values()))
        rec = self.collectives.setdefault(coll, {"count": 0.0, "bytes": 0.0})
        rec["count"] += 1
        rec["bytes"] += moved
        read = sum(b for k, b in _by_storage(ins).items() if k not in out_st)
        self._add_bytes(name, read + moved, outs)
        if self._contrib:
            c = self.coll_by_op[(coll, _shape(outs))]
            c[0] += moved
            c[1] += 1

    def _add_bytes(self, name: str, nbytes: float, outs) -> None:
        self.hbm_bytes += nbytes
        if self._contrib:
            rec = self.hbm_by_op[(name, _shape(outs))]
            rec[0] += nbytes
            rec[1] += 1

    def _track(self, storage) -> None:
        k = id(storage)
        if k in self._args or k in self._live:
            return
        n = storage.nbytes()
        self._live[k] = n
        self.live_bytes += n
        self.temp_bytes = max(self.temp_bytes, self.live_bytes)
        self._finalizers.append(weakref.finalize(storage, self._free, k))

    def _free(self, k: int) -> None:
        self.live_bytes -= self._live.pop(k)

    def close(self) -> None:
        """Stop tracking the storages still alive (the call's outputs)."""
        for f in self._finalizers:
            f.detach()
        self._finalizers.clear()

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_dtype.values()))


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a tree of tuples, lists and dicts (an op's arguments
    and outputs, a call's); a DTensor's is its local shard."""
    out: List[torch.Tensor] = []
    _walk(tree, out)
    return out


def _walk(x, out: list) -> None:
    # a module-level function: a nested recursive one would be a reference
    # cycle holding `out`, and so the tensors, until the collector runs
    if isinstance(x, torch.Tensor):
        out.append(x._local_tensor if isinstance(x, DTensor) else x)
    elif isinstance(x, (tuple, list)):
        for y in x:
            _walk(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _walk(y, out)


def _shape(outs) -> str:
    return " ".join(f"{str(t.dtype).removeprefix('torch.')}{list(t.shape)}"
                    for t in outs[:2])[:70]


def _top(by_op: dict, n: int) -> list:
    rows = sorted(((b, op, ty, calls) for (op, ty), (b, calls) in by_op.items()),
                  reverse=True)[:n]
    return [dict(bytes=float(f"{b:.4g}"), op=op, type=ty, calls=calls)
            for b, op, ty, calls in rows]


def analyze(fn: Callable, *args, top_n: int = 0) -> dict:
    """Run fn(*args) under an `OpCounter` → JAX's keys (`flops`,
    `hbm_bytes`, `collectives` {op: {count, bytes}},
    `collective_bytes_total`; with top_n also `top_hbm` and `top_coll`,
    the largest contributors by op and output type, each with its calls)
    plus `flops_by_dtype`, `kernels` (each reported kernel's calls, bytes
    and FLOPs), `argument_bytes`, `temp_bytes`, `output_bytes`, `n_ops`,
    `host_syncs` (the contracts' host-sync reasons), `seconds` (host time
    of the traced call) and `out`, fn's result."""
    counter = OpCounter(args, keep_contributors=bool(top_n))
    t0 = time.perf_counter()
    try:
        with counter:
            out = fn(*args)
    finally:
        counter.close()
    seconds = time.perf_counter() - t0
    result = {
        "flops": counter.flops,
        "flops_by_dtype": dict(counter.flops_by_dtype),
        "hbm_bytes": counter.hbm_bytes,
        "collectives": counter.collectives,
        "collective_bytes_total": sum(v["bytes"] for v in counter.collectives.values()),
        "kernels": counter.kernels,
        "argument_bytes": sum(_nbytes(t) for t in _tensors(args)),
        "temp_bytes": counter.temp_bytes,
        "output_bytes": sum(_nbytes(t) for t in _tensors(out)),
        "n_ops": counter.n_ops,
        "host_syncs": counter.host_syncs,
        "seconds": seconds,
        "out": out,
    }
    if top_n:
        result["top_hbm"] = _top(counter.hbm_by_op, top_n)
        result["top_coll"] = _top(counter.coll_by_op, top_n)
    return result
