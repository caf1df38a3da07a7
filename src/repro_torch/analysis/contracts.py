"""Declarative op-trace contracts for the port's entry points (PyTorch port
of `repro/analysis/contracts.py`, DESIGN.md §3.14).

Each contract is a trace-spec builder decorated with `@jaxpr_contract`
(the JAX package's name, so the registries read the same): the builder
constructs a tiny-but-representative workload (index, queries, codebooks)
on the device it is given and returns a `TraceSpec`; the checker runs it
once under `OpRecorder`, a `TorchDispatchMode` that stands for
`jax.make_jaxpr`: for every aten op the entry point dispatches it keeps
the op's name and each output's shape, dtype and device (metadata only,
never a tensor, so a full-width trace keeps nothing alive). It enforces:

  no_dims={"n"}       no op output is (n,)-shaped or carries n in a
                      non-leading axis — the SOAR candidate-local invariant
                      (no per-query intermediate scales with the database;
                      a leading-n axis is allowed: build-path ops stream
                      over all points by design, e.g. (n, d) input views).
  no_dims_1d={"n"}    only 1-D outputs of n or more elements are forbidden
                      — the Lloyd "no second-pass vector" rule.
  no_products={"n*c"} no output's element count reaches the named dims'
                      product — the "nothing dense in (points × centroids)"
                      build-path rule.
  forbid_dtypes       no output carries the dtype (f64 leak guard).
  host sync           no op in the trace makes the host wait for the
                      device (`HOST_SYNC_OPS`, `host_sync`): it would stall
                      the serving pipeline on a host round-trip, and a tile
                      that waits on the host cannot be captured in a CUDA
                      graph. This rule takes the place of JAX's
                      `forbid_primitives` and is held by every contract.

Rule ids are the JAX package's ("jaxpr-dim", "jaxpr-dtype"), so reports
and baselines read the same in both packages; the host-sync rule's is
"host-sync". JAX's `max_cache_growth` has no counterpart: torch has no
jit cache, and the kernel library is built once per hash of its sources.

Views (`select`, `slice`, `permute`, ...) are ops and are recorded; an
in-place op (`masked_fill_`) records its result, the input's shape, once.
The hand-written kernels launch through `ctypes`, which no dispatch mode
sees: a trace on the card records the buffers their wrappers allocate,
and the caller counts their launches (`chip_smoke.py`).

Trace sizes are deliberately prime (N_TRACE = 16,411) so a forbidden dim
can't collide with a legitimate product of small axes, and N_TRACE is
above the plain versions' row chunks (16,384 in `kernels/ref.py`, 8,192 in
`kernels/soar_assign.py` and Lloyd's) so that on the CPU a chunk never
covers all n.

Where the port's design departs from a JAX rule the contract says so:
Lloyd's sweep and the fused assignment hold `no_products={"n*c"}` without
`no_dims_1d` (see their builders).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.analysis.findings import Finding
from repro_torch.utils import Device, resolve_device

# Ops that make the host wait for the device wherever they run: a scalar
# read back (`.item()`, `int(t)`, `bool(t)`, `torch.equal`) or an output
# whose size depends on the data (nonzero, masked_select, unique).
HOST_SYNC_OPS = frozenset({
    "aten._local_scalar_dense", "aten.equal", "aten.nonzero",
    "aten.masked_select",
    "aten._unique", "aten._unique2", "aten.unique_dim",
    "aten.unique_consecutive", "aten.unique_dim_consecutive",
})

# Shared tiny-fixture scale. N_TRACE prime and above the plain versions'
# row chunks; the rest as in the JAX package.
N_TRACE, D_TRACE, C_TRACE = 16_411, 16, 24
NQ_TRACE, TOP_T, FINAL_K = 5, 6, 5


def host_sync(func, args, kwargs, out, ins=None, outs=None) -> Optional[str]:
    """The reason op `func` (called on args / kwargs, giving `out`) makes
    the host wait for the device, or None: an op of `HOST_SYNC_OPS`;
    `repeat_interleave` by a tensor of repeats without `output_size`;
    `index` by a boolean (or uint8) mask; and any op that reads a CUDA
    tensor and writes a CPU one (a device-to-host copy). `ins` / `outs`,
    where the caller has them, are the input and output tensors."""
    name = str(func)
    if str(func.overloadpacket) in HOST_SYNC_OPS:
        return name
    if (func is torch.ops.aten.repeat_interleave.Tensor
            and kwargs.get("output_size") is None):
        return f"{name}:no-output_size"
    if func is torch.ops.aten.index.Tensor and any(
            i is not None and i.dtype in (torch.bool, torch.uint8)
            for i in args[1]):
        return f"{name}:bool-index"
    if ins is None:
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
    if outs is None:
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    if any(t.is_cuda for t in ins) and any(t.device.type == "cpu" for t in outs):
        return f"{name}:cuda->cpu"
    return None


@dataclass(frozen=True)
class OpOutput:
    """One output of one recorded op: metadata only. `view`: the op
    returns a view of an input (no new memory)."""
    op: str
    shape: Tuple[int, ...]
    dtype: str
    device: str
    itemsize: int
    view: bool

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.itemsize


class OpRecorder(TorchDispatchMode):
    """Records every aten op dispatched while it is active: `n_ops`, each
    tensor output's (op, shape, dtype, device) in `outputs`, and each host
    sync's reason (`host_sync`) in `syncs`. No tensor is kept."""

    def __init__(self) -> None:
        super().__init__()
        self.n_ops = 0
        self.outputs: List[OpOutput] = []
        self.syncs: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.n_ops += 1
        sync = host_sync(func, args, kwargs, out)
        if sync is not None:
            self.syncs.append(sync)
        name = str(func)
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.outputs.append(OpOutput(
                    name, tuple(t.shape), str(t.dtype).removeprefix("torch."),
                    t.device.type, t.element_size(), view))
        return out


@dataclass
class TraceSpec:
    """One traceable workload: `fn` closes over all static args and takes
    only the tensors (or tensor tuples) in `args`, made before tracing.
    `dims` maps the contract's symbolic dim names to this trace's concrete
    sizes."""
    fn: Callable
    args: Tuple
    dims: Dict[str, int] = field(default_factory=dict)


@dataclass
class JaxprContract:
    name: str
    build: Callable[[torch.device], TraceSpec]
    no_dims: frozenset = frozenset()
    no_dims_1d: frozenset = frozenset()
    no_products: frozenset = frozenset()
    forbid_dtypes: frozenset = frozenset({"float64"})


REGISTRY: Dict[str, JaxprContract] = {}


def jaxpr_contract(name: Optional[str] = None, *, no_dims=(), no_dims_1d=(),
                   no_products=(), forbid_dtypes=("float64",),
                   registry: Optional[Dict[str, JaxprContract]] = None):
    """Declare + register a contract over a trace-spec builder, which
    takes the device to build its workload on."""
    def deco(build):
        cname = name or build.__name__.lstrip("_")
        contract = JaxprContract(
            cname, build, frozenset(no_dims), frozenset(no_dims_1d),
            frozenset(no_products), frozenset(forbid_dtypes))
        (REGISTRY if registry is None else registry)[cname] = contract
        return build
    return deco


# ------------------------------------------------------------------ checker

def _dim_violation(shape, v: int) -> bool:
    """The candidate-local predicate: (v,) exactly, or v in any
    non-leading axis (a leading-v axis is a streamed-over-points view).
    Leading size-1 axes are stripped first — the JAX package's shard_map
    view arrives as (1, n_local, d), the shard axis in front of the same
    legitimate leading-n database view."""
    while len(shape) > 1 and shape[0] == 1:
        shape = shape[1:]
    if shape == (v,):
        return True
    return len(shape) >= 2 and v in shape[1:]


def _product_threshold(spec_dims: Dict[str, int], prod: str) -> int:
    """Parse "n*c" / "2*n*d": tokens are dim names or integer literals."""
    out = 1
    for tok in prod.split("*"):
        out *= int(tok) if tok.isdigit() else spec_dims[tok]
    return out


def record_ops(spec: TraceSpec) -> OpRecorder:
    """Run `spec` once under a fresh `OpRecorder` and return it."""
    with OpRecorder() as rec:
        spec.fn(*spec.args)
    return rec


def evaluate(contract: JaxprContract, spec: TraceSpec,
             rec: OpRecorder) -> List[Finding]:
    """The contract's findings over one recorded run of `spec`."""
    path = f"contract:{contract.name}"
    vals = rec.outputs
    findings: List[Finding] = []

    for dim in sorted(contract.no_dims):
        v = spec.dims[dim]
        bad = sorted({o.shape for o in vals if _dim_violation(o.shape, v)})
        if bad:
            findings.append(Finding(
                "jaxpr-dim", path, context=contract.name,
                snippet=f"{dim}={v}:{bad}",
                message=(f"intermediates carry forbidden dim {dim}={v}: "
                         f"{bad}")))
    for dim in sorted(contract.no_dims_1d):
        v = spec.dims[dim]
        bad = sorted({o.shape for o in vals
                      if len(o.shape) == 1 and o.shape[0] >= v})
        if bad:
            findings.append(Finding(
                "jaxpr-dim", path, context=contract.name,
                snippet=f"{dim}(1d)={v}:{bad}",
                message=f"1-D intermediates of forbidden dim {dim}: {bad}"))
    for prod in sorted(contract.no_products):
        v = _product_threshold(spec.dims, prod)
        bad = sorted({o.shape for o in vals if math.prod(o.shape) >= v})
        if bad:
            findings.append(Finding(
                "jaxpr-dim", path, context=contract.name,
                snippet=f"{prod}>={v}:{bad}",
                message=(f"intermediates reach forbidden size "
                         f"{prod}={v}: {bad}")))
    for o in vals:
        if o.dtype in contract.forbid_dtypes:
            findings.append(Finding(
                "jaxpr-dtype", path, context=contract.name,
                snippet=f"{o.op}:{o.dtype}{list(o.shape)}",
                message=(f"forbidden dtype {o.dtype} leaks from "
                         f"`{o.op}` (shape {list(o.shape)})")))
    for s in sorted(set(rec.syncs)):
        findings.append(Finding(
            "host-sync", path, context=contract.name, snippet=s,
            message=f"host sync `{s}` in the trace"))
    return findings


def check_contract(contract: JaxprContract,
                   device: Device = None) -> List[Finding]:
    """Trace `contract` over its own tiny workload on `device` (CUDA unless
    the caller passes "cpu") and return its findings. A workload of
    another size goes through `record_ops` and `evaluate`."""
    spec = contract.build(resolve_device(device))
    return evaluate(contract, spec, record_ops(spec))


def check_all_contracts(names=None, device: Device = None) -> List[Finding]:
    dev = resolve_device(device)
    findings: List[Finding] = []
    for name, c in sorted(REGISTRY.items()):
        if names and name not in names:
            continue
        findings.extend(check_contract(c, dev))
    return findings


# ------------------------------------------------------- shared tiny fixture

@functools.lru_cache(maxsize=None)
def _tiny_dataset():
    rng = np.random.default_rng(7)
    X = rng.standard_normal((N_TRACE, D_TRACE)).astype(np.float32)
    Q = rng.standard_normal((NQ_TRACE, D_TRACE)).astype(np.float32)
    return X, Q


@functools.lru_cache(maxsize=None)
def _tiny_index(device: str):
    from repro_torch.core.ivf import build_ivf
    from repro_torch.core.search import pack_ivf
    X, _ = _tiny_dataset()
    idx = build_ivf(torch.Generator().manual_seed(0), X, C_TRACE,
                    spill_mode="soar", pq_subspaces=8, train_iters=3,
                    device=device)
    return idx, pack_ivf(idx)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(a, device=device)


def _sample_centroids(seed: int, device) -> torch.Tensor:
    X, _ = _tiny_dataset()
    rng = np.random.default_rng(seed)
    return _tensor(X[rng.choice(N_TRACE, C_TRACE, replace=False)], device)


# ------------------------------------------------------------ serving traces

@jaxpr_contract("search_jit", no_dims={"n"})
def _spec_search_jit(device):
    from repro_torch.core.search import search_jit
    _, Q = _tiny_dataset()
    _, packed = _tiny_index(str(device))
    kw = dict(top_t=TOP_T, final_k=FINAL_K, rerank_budget=64,
              multiplicity=2)
    return TraceSpec(fn=lambda p, q: search_jit(p, q, **kw),
                     args=(packed, _tensor(Q, device)), dims={"n": N_TRACE})


@jaxpr_contract("search_jit_batched", no_dims={"n"})
def _spec_search_jit_batched(device):
    from repro_torch.core.search import pad_queries, search_jit_batched
    _, Q = _tiny_dataset()
    _, packed = _tiny_index(str(device))
    Qp, _, bq = pad_queries(Q, 128)
    kw = dict(top_t=TOP_T, final_k=FINAL_K, rerank_budget=64,
              multiplicity=2, bq=bq)
    return TraceSpec(fn=lambda p, q: search_jit_batched(p, q, **kw),
                     args=(packed, _tensor(Qp, device)), dims={"n": N_TRACE})


@jaxpr_contract("search_jit_batched_filtered", no_dims={"n"})
def _spec_search_jit_batched_filtered(device):
    # the filter is an (n,) uint8 tensor on the device, made before the
    # trace (JAX's spec passes a jnp array): converting one is not the
    # search's work, and the rule allows no (n,) output
    from repro_torch.core.search import pad_queries, search_jit_batched
    _, Q = _tiny_dataset()
    _, packed = _tiny_index(str(device))
    rng = np.random.default_rng(3)
    filt = _tensor((rng.random(N_TRACE) < 0.3).astype(np.uint8), device)
    Qp, _, bq = pad_queries(Q, 128)
    kw = dict(top_t=TOP_T, final_k=FINAL_K, rerank_budget=64,
              multiplicity=2, bq=bq, escalate=True)
    return TraceSpec(
        fn=lambda p, q, f: search_jit_batched(p, q, filter=f, **kw),
        args=(packed, _tensor(Qp, device), filt), dims={"n": N_TRACE})


@jaxpr_contract("tree_route")
def _spec_tree_route(device):
    from repro_torch.kernels.tree_route import tree_route
    rng = np.random.default_rng(11)
    S, cmax = 5, 17
    SC = _tensor(rng.standard_normal((S, D_TRACE)).astype(np.float32), device)
    CC = _tensor(rng.standard_normal((S, cmax, D_TRACE)).astype(np.float32),
                 device)
    CH = _tensor(rng.integers(0, S * cmax, (S, cmax)).astype(np.int32), device)
    _, Q = _tiny_dataset()
    return TraceSpec(
        fn=lambda q, sc, cc, ch: tree_route(q, sc, cc, ch, 2),
        args=(_tensor(Q, device), SC, CC, CH), dims={})


# -------------------------------------------------------------- build traces
# Departure from JAX's rule: the port's Lloyd sweep and fused assignment
# hold no_products={"n*c"} but not no_dims_1d={"n"}. On the card the sweep
# keeps (n,) idx and mind between its assignment and grouping launches and
# allocates one int32 scratch of nb·c + 2c + n elements
# (`kernels/lloyd.py::assign_phase`, `group_phase`); `assign_fused` hands
# the (n,) primary from the vq kernel to the soar kernel, and on the card
# the prepared codebook's fragments are one 1-D buffer that can exceed n.
# The plain versions keep the primary as an (n,) vector too. None of these
# is a per-query or (n × c) buffer.

@jaxpr_contract("lloyd_sweep", no_products={"n*c"})
def _spec_lloyd_sweep(device):
    from repro_torch.kernels.lloyd import lloyd_sweep
    X, _ = _tiny_dataset()
    C = _sample_centroids(5, device)
    return TraceSpec(fn=lambda x, c: lloyd_sweep(x, c),
                     args=(_tensor(X, device), C),
                     dims={"n": N_TRACE, "c": C_TRACE})


@jaxpr_contract("assign_fused", no_products={"n*c"})
def _spec_assign_fused(device):
    from repro_torch.kernels.soar_assign import assign_fused
    X, _ = _tiny_dataset()
    C = _sample_centroids(6, device)
    return TraceSpec(
        fn=lambda x, c: assign_fused(x, c, lam=1.0, n_spills=1),
        args=(_tensor(X, device), C), dims={"n": N_TRACE, "c": C_TRACE})


@jaxpr_contract("pq_encode", no_products={"2*n*d"})
def _spec_pq_encode(device):
    # threshold 2·n·d: the streamed encoder's largest legitimate buffers
    # are O(n·d) views of X (codes are n·m ≪ n·d); a dense all-subspace
    # distance matrix (n, m, 16) = 8·n·d trips the bound
    from repro_torch.quant.pq import pq_encode
    idx, _ = _tiny_index(str(device))
    X, _ = _tiny_dataset()
    return TraceSpec(fn=lambda c, x: pq_encode(c, x, chunk=512),
                     args=(idx.pq, _tensor(X, device)),
                     dims={"n": N_TRACE, "d": D_TRACE})


# -------------------------------------------------------- distributed makers
# One shard on the one device asked for, as JAX's one-device mesh: n is
# the shard's n_local.

@jaxpr_contract("distributed_search", no_dims={"n"})
def _spec_distributed_search(device):
    from repro_torch.core.distributed import (build_sharded_ivf,
                                              make_distributed_search)
    X, Q = _tiny_dataset()
    sivf = build_sharded_ivf(2, X, 1, C_TRACE, train_iters=3, device=device)
    fn = make_distributed_search([device], top_t=TOP_T, final_k=FINAL_K,
                                 multiplicity=2)
    return TraceSpec(fn=fn, args=(sivf, _tensor(Q, device)),
                     dims={"n": N_TRACE})


@jaxpr_contract("distributed_search_pq", no_dims={"n"})
def _spec_distributed_search_pq(device):
    from repro_torch.core.distributed import (build_sharded_ivf_pq,
                                              make_distributed_search_pq)
    X, Q = _tiny_dataset()
    sivf = build_sharded_ivf_pq(2, X, 1, C_TRACE, 8, train_iters=3,
                                device=device)
    fn = make_distributed_search_pq([device], top_t=TOP_T, final_k=FINAL_K,
                                    rerank_k=32, q_chunk=NQ_TRACE,
                                    multiplicity=2)
    return TraceSpec(fn=fn, args=(sivf, _tensor(Q, device)),
                     dims={"n": N_TRACE})


@jaxpr_contract("replicated_search", no_dims={"n"})
def _spec_replicated_search(device):
    from repro_torch.core.distributed import make_replicated_search
    _, Q = _tiny_dataset()
    _, packed = _tiny_index(str(device))
    fn = make_replicated_search([device], top_t=TOP_T, final_k=FINAL_K,
                                rerank_budget=64, multiplicity=2)
    return TraceSpec(fn=fn, args=(packed, _tensor(Q, device)),
                     dims={"n": N_TRACE})


@jaxpr_contract("sharded_assign", no_products={"n*c"})
def _spec_sharded_assign(device):
    # assign_fused per device: the same departure as `assign_fused`
    from repro_torch.core.distributed import make_sharded_assign
    X, _ = _tiny_dataset()
    C = _sample_centroids(8, device)
    fn = make_sharded_assign([device])
    return TraceSpec(fn=fn, args=(_tensor(X, device), C),
                     dims={"n": N_TRACE, "c": C_TRACE})
