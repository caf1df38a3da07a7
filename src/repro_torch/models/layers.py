"""Shared model layers (PyTorch port of `repro/models/layers.py`): norms,
MLPs, rotary embeddings, embeddings, the cross entropy and logical-axis
sharding.

All functions are pure; parameters arrive as dict trees of tensors in the
JAX package's layouts (built in transformer.py from ParamDefs). Each
product casts its weight to the activation's dtype, as JAX's einsums do.

Sharding: the same code runs on plain tensors and on DTensors over a
`DeviceMesh` (`launch/mesh.py`). `shard(x, *axes)` is JAX's logical
constraint: with rules set (`set_logical_rules`) and x a DTensor it
redistributes x to the placements its logical axes map to; with no rules,
or a plain tensor, it returns x unchanged — JAX's "no mesh" path. Between
two constraints DTensor's own sharding propagation partitions each op, as
GSPMD does between JAX's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from repro_torch.launch.mesh import local_range, to_placements
from repro_torch.models.params import ParamDef, spec_of

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# ---------------------------------------------------------------- sharding

_MESH_RULES: dict = {}     # set by the launchers (logical → mesh axes)


def set_logical_rules(rules: dict):
    global _MESH_RULES
    _MESH_RULES = dict(rules)


def get_logical_rules() -> dict:
    return dict(_MESH_RULES)


def shard(x, *axes):
    """Apply a logical sharding constraint if x lies on a mesh."""
    if not _MESH_RULES or not isinstance(x, DTensor):
        return x
    target = to_placements(x.device_mesh, spec_of(axes, _MESH_RULES))
    if tuple(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, target)


def gelu(x):
    """`jax.nn.gelu`'s default, the tanh approximation (torch's default is
    the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def matmul_w(x, w, n_in: int = 1):
    """x (..., *w.shape[:n_in]) · w → (..., *w.shape[n_in:]) in x's dtype:
    JAX's `einsum("...d,d...->...", x, w.astype(x.dtype))` as one matmul."""
    if isinstance(w, DTensor):
        return _matmul_dtensor(x, w, n_in)
    return _matmul_local(x, w, n_in)


def _matmul_dtensor(x, w, n_in: int):
    """`matmul_w` on a DTensor weight, partitioned as GSPMD partitions the
    einsum, one mesh dim at a time:
    - w sharded on a contraction dim: where x is replicated or sharded on
      the same dim, each rank contracts its part and the output is a
      partial sum; where x's batch dims use the mesh dim, w is gathered
      over it (FSDP's gather);
    - w sharded on an output dim: the output is sharded there (TP), x
      gathered over that mesh dim where it was sharded on a contraction
      dim; where x's batch dims use the mesh dim, w is gathered instead;
    - w replicated: the output takes x's batch sharding; an x sharded on
      a contraction dim meets w's own slice of it (a partial sum).
    The local product is the plain one: DTensor's own propagation would
    shard a dim over any mesh dim it finds free, and then fail to unflatten
    the output where that dim does not divide."""
    from torch.distributed.tensor import Partial, Replicate

    nl = x.dim() - n_in
    xp, wp, outp = list(x.placements), list(w.placements), []
    for m, (px, pw) in enumerate(zip(xp, wp)):
        if px.is_partial():
            xp[m] = px = Replicate()
        if isinstance(pw, Shard) and pw.dim < n_in:           # contraction dim
            if px.is_replicate():
                xp[m] = px = Shard(nl + pw.dim)                # x's own slice
            if px == Shard(nl + pw.dim):
                outp.append(Partial())
                continue
            wp[m] = pw = Replicate()
        if isinstance(pw, Shard):                             # output dim
            if isinstance(px, Shard) and px.dim < nl:
                wp[m] = pw = Replicate()
            else:
                xp[m] = Replicate()
                outp.append(Shard(nl + pw.dim - n_in))
                continue
        if isinstance(px, Shard) and px.dim >= nl:            # w replicated
            wp[m] = Shard(px.dim - nl)
            outp.append(Partial())
        else:
            outp.append(px)
    return local_call(_matmul_local, (x, w, n_in), (xp, wp, None), outp, w.device_mesh)


def local_fn(fn, args, in_axes, out_axes):
    """fn(*args) on each rank's shards, JAX's `shard_map` for a body that
    needs no collective (a recurrence over time whose batch, head and
    width dims are independent). Where an arg is a DTensor and rules are
    set, each tensor arg is placed by its logical axes (one name or None
    a dim; a plain tensor is taken as replicated first), fn runs on the
    local tensors, and its outputs (a tuple) are placed by `out_axes`.
    Otherwise fn(*args)."""
    mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)), None)
    if mesh is None or not _MESH_RULES:
        return fn(*args)
    def place(axes):
        return list(to_placements(mesh, spec_of(axes, _MESH_RULES)))
    return local_call(fn, args, [place(ax) for ax in in_axes],
                      tuple(place(ax) for ax in out_axes), mesh)


def local_call(fn, args, in_pl, out_pl, mesh):
    """fn on each rank's local tensors (JAX's `shard_map`): each tensor
    arg (a plain one taken as replicated first) placed by its entry of
    `in_pl` (None: passed as it is), fn's output made a DTensor with
    `out_pl` (a list of placements), or its tuple of outputs with a tuple
    of lists. A gradient comes back to an input with `grad_placements`
    (DTensor's `to_local(grad_placements=)`)."""
    from torch.distributed.tensor import Replicate

    outs = list(out_pl) if isinstance(out_pl, tuple) else [out_pl]
    local = []
    for a, pl in zip(args, in_pl):
        if pl is None or not isinstance(a, torch.Tensor):
            local.append(a)
            continue
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
        if tuple(a.placements) != tuple(pl):
            a = a.redistribute(mesh, pl)
        local.append(a.to_local(grad_placements=grad_placements(pl, *outs)))
    res = fn(*local)
    if not isinstance(out_pl, tuple):
        return DTensor.from_local(res, mesh, out_pl, run_check=False)
    return tuple(DTensor.from_local(r, mesh, pl, run_check=False) for r, pl in zip(res, outs))


def grad_placements(inp, *outs):
    """The gradient's placements of a `local_call` input: where the input is
    replicated over a mesh dim but the ranks there compute different parts
    (an output sharded or a partial sum), each rank's gradient is its own
    part of the sum (Partial); elsewhere the input's own placements."""
    from torch.distributed.tensor import Partial

    return [Partial() if p.is_replicate() and any(not o[m].is_replicate() for o in outs)
            else p for m, p in enumerate(inp)]


def _matmul_local(x, w, n_in: int):
    k = 1
    for s in w.shape[:n_in]:
        k *= s
    y = x.reshape(*x.shape[:x.dim() - n_in], k) @ w.to(x.dtype).reshape(k, -1)
    return y.reshape(*y.shape[:-1], *w.shape[n_in:])


# ------------------------------------------------------------------- norms

def rmsnorm_def(d: int) -> dict:
    return {"scale": ParamDef((d,), (None,), init="ones")}


def rmsnorm(p, x, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * p["scale"].float()
    return out.to(x.dtype)


# -------------------------------------------------------------------- MLPs

def mlp_def(cfg, d_ff: int) -> dict:
    d = cfg.d_model
    if cfg.mlp in ("swiglu", "geglu"):
        return {
            "wi": ParamDef((d, 2, d_ff), ("embed", None, "mlp")),
            "wo": ParamDef((d_ff, d), ("mlp", "embed")),
        }
    return {   # squared_relu / gelu: plain 2-matrix MLP
        "wi": ParamDef((d, d_ff), ("embed", "mlp")),
        "wo": ParamDef((d_ff, d), ("mlp", "embed")),
    }


def mlp(p, x, cfg):
    h = matmul_w(x, p["wi"])
    if cfg.mlp in ("swiglu", "geglu"):
        gate, up = h[..., 0, :], h[..., 1, :]
        act = F.silu(gate) if cfg.mlp == "swiglu" else gelu(gate)
        h = act * up
    elif cfg.mlp == "squared_relu":
        h = torch.square(F.relu(h))
    else:
        h = gelu(h)
    h = shard(h, "batch", None, "mlp")
    return matmul_w(h, p["wo"])


# -------------------------------------------------------------------- RoPE

def rope(x, positions, theta: float = 10_000.0):
    """x: (..., seq, heads, hd); positions: (..., seq) int. Rotates the two
    halves of hd (not interleaved pairs), angles in f32."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., None].float() * freqs                   # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                           # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


# -------------------------------------------------------------- embeddings

def embed_def(cfg) -> dict:
    return {"table": ParamDef((cfg.vocab_padded, cfg.d_model),
                              ("vocab", "embed"), scale=1.0)}


def embed(p, tokens, cfg):
    if isinstance(p["table"], DTensor):
        # the table's FSDP gather over its embed dim first: the lookup then
        # runs on vocab shards (a masked gather and a sum over them)
        out = _lookup_sharded(shard(p["table"], "vocab", None), tokens)
    else:
        out = p["table"][tokens]
    return shard(out.to(DTYPES[cfg.compute_dtype]), "batch", None, "act_embed")


def unembed(p, x, cfg):
    """Final projection to (padded) vocab logits through the embedding."""
    logits = x @ p["table"].to(x.dtype).T
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return shard(logits, "batch", None, "vocab")


def head_def(cfg) -> dict:
    """Separate output head (used when not tying to the embedding)."""
    return {"w": ParamDef((cfg.d_model, cfg.vocab_padded),
                          ("embed", "vocab"))}


def softmax_xent(logits, labels, vocab_size: int):
    """Cross entropy over the (padded) vocab dim; padded ids never occur in
    labels. fp32 accumulation."""
    if isinstance(logits, DTensor):
        return _xent_sharded(logits, labels)
    logits = logits.float()
    m = torch.amax(logits, dim=-1, keepdim=True)
    shifted = logits - m.detach()
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1))
    gold = torch.gather(shifted, -1, labels[..., None].long())[..., 0]
    return lse - gold


def _xent_sharded(logits, labels):
    """`softmax_xent` on a DTensor of logits whose vocab dim may be sharded,
    on each rank's local tensors: the max by an all-reduce over the vocab's
    mesh dims, then the exp-sum and the labels' logits (each rank's own
    range, 0 elsewhere) summed across them (`collectives.sum_shared`). The
    reductions are explicit: DTensor's own over a sharded dim give wrong
    gradients on torch 2.11 (an amax's is NaN; the log-sum-exp's 4x on a
    (2, 2) mesh)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate

    from repro_torch.collectives import sum_shared

    mesh, vdim = logits.device_mesh, logits.dim() - 1
    pl = [Replicate() if p.is_partial() else p for p in logits.placements]
    groups = [mesh.get_group(m) for m, p in enumerate(pl) if p == Shard(vdim)]
    lo = local_range(logits.shape, mesh, pl)[0][vdim]
    out = [Replicate() if p == Shard(vdim) else p for p in pl]
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim, run_check=False)

    def xent(x, y):
        x = x.float()
        m = torch.amax(x, dim=-1, keepdim=True).detach()
        for g in groups:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
        shifted = x - m
        s = torch.sum(torch.exp(shifted), dim=-1)
        idx = y.long() - lo
        ok = (idx >= 0) & (idx < x.shape[-1])
        gold = torch.gather(shifted, -1, idx.clamp(0, x.shape[-1] - 1)[..., None])[..., 0]
        gold = torch.where(ok, gold, torch.zeros((), dtype=gold.dtype, device=gold.device))
        for g in groups:
            s, gold = sum_shared(s, g), sum_shared(gold, g)
        return torch.log(s) - gold
    return local_call(xent, (logits, labels), (pl, out), out, mesh)


def _lookup_sharded(table, ids):
    """An embedding lookup in a DTensor table whose vocab dim may be
    sharded: each rank takes the ids inside its own rows (0 elsewhere),
    and the result is a partial sum over the mesh dims that shard them.
    The ids are placed by the "batch" rule first."""
    from torch.distributed.tensor import Partial, Replicate

    mesh = table.device_mesh
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim, run_check=False)
    ids = shard(ids, "batch", *[None] * (ids.dim() - 1))
    pl = [Replicate() if p.is_partial() else p for p in table.placements]
    lo = local_range(table.shape, mesh, pl)[0][0]
    id_pl = [Replicate() if p == Shard(0) else p for p in ids.placements]
    out = [Partial() if p == Shard(0) else q for p, q in zip(pl, id_pl)]

    def take(s, y):
        idx = y.long() - lo
        ok = (idx >= 0) & (idx < s.shape[0])
        return s[idx.clamp(0, s.shape[0] - 1)] * ok[..., None].to(s.dtype)
    return local_call(take, (table, ids), (pl, id_pl), out, mesh)
