"""Mixture-of-Experts MLP (PyTorch port of `repro/models/moe.py`):
sort-based (permutation) dispatch on one device.

Dispatch: tokens' top-k expert slots are stable-sorted by expert id; each
expert processes a fixed capacity C = T·k·capacity_factor // E + 1 slots
(overflow goes to a trash row and is dropped). The combine is JAX's
scatter-add `.at[token].add` made deterministic: every token owns exactly
k slots, so the slots are un-sorted to (T, k) — each token's in the
sorted (expert) order, the order JAX's scatter adds them — and summed
over k one slot at a time. `index_add_` on CUDA would add with atomics
and not give the same bits twice.

Expert parallelism (JAX's `_moe_shardmap`): under `ep_group`, a
torch.distributed group of ep ranks, rank r holds experts
[r·E/ep, (r+1)·E/ep) of `wi` and `wo` (`local_experts` cuts them) and the
whole router. Every rank routes every token, keeps the slots of its own
experts (the same capacity and sort order as the dense path), and the
partial outputs are summed by one all-reduce a layer. The input and the
router are read by every rank for its own part, so their gradients are
summed across ranks (`collectives.sum_grads`); the output's is not
(`collectives.sum_shared`). The sum across ranks adds in another order
than the dense path's slot order, so the two agree to rounding.

On a mesh (x a DTensor, `rules["expert"]` a mesh dim) the same body runs
on each rank's local tensors (`layers.local_call`, JAX's `_moe_shardmap`)
with the mesh's expert dim as its group (`_moe_on_mesh`).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import collectives
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.launch.mesh import to_placements
from repro_torch.models.layers import get_logical_rules, local_call, shard
from repro_torch.models.params import ParamDef
from repro_torch.utils import topk_first


def moe_def(cfg) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    return {
        "router": ParamDef((d, e), ("embed", None)),
        "wi": ParamDef((e, d, 2, f), ("expert", "embed", None, "expert_mlp")),
        "wo": ParamDef((e, f, d), ("expert", "expert_mlp", "embed")),
    }


def _route(router, xt, k):
    """Top-k routing with renormalized gates. xt: (T, d). Ties go to the
    lower expert id, as `lax.top_k` gives."""
    logits = xt.float() @ router.float()
    gates, eidx = topk_first(logits, k)
    return torch.softmax(gates, dim=-1), eidx


def _expert_compute(p, xe, dt):
    """(E, cap, d) → (E, cap, d) through the gated expert MLP."""
    E, cap, d = xe.shape
    f = p["wo"].shape[1]
    h = torch.bmm(xe, p["wi"].to(dt).reshape(E, d, 2 * f)).reshape(E, cap, 2, f)
    h = F.silu(h[:, :, 0, :]) * h[:, :, 1, :]
    return torch.bmm(h, p["wo"].to(dt))


def _dispatch_compute_combine(p, xt, gates, eidx, e_lo, E_local, cap, dt):
    """Sort slots by (local) expert, capacity-drop, compute, combine.

    e_lo/E_local select this shard's expert range ([0, E) on 1 device).
    """
    T, d = xt.shape
    k = eidx.shape[1]
    dev = xt.device
    flat_e = eidx.reshape(-1)
    flat_g = gates.reshape(-1)
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    le = flat_e - e_lo
    mine = (le >= 0) & (le < E_local)
    le = torch.where(mine, le, E_local)                # trash bucket
    order = torch.sort(le, stable=True).indices
    se, sg, stok = le[order], flat_g[order], flat_t[order]
    counts = torch.bincount(se, minlength=E_local + 1)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * k, device=dev) - starts[se]
    keep = (pos_in_e < cap) & (se < E_local)
    slot = torch.where(keep, se * cap + pos_in_e, E_local * cap)

    buf = torch.zeros((E_local * cap + 1, d), dtype=dt, device=dev)
    buf[slot] = xt[stok].to(dt)           # duplicates only in the trash row
    ye = _expert_compute(p, buf[:E_local * cap].reshape(E_local, cap, d), dt)
    yflat = ye.reshape(E_local * cap, d)
    yslot = torch.where(keep[:, None],
                        yflat[torch.clamp(slot, max=E_local * cap - 1)],
                        torch.zeros((), dtype=dt, device=dev))
    contrib = yslot * sg[:, None].to(dt)
    # each token's k slots, in sorted order: (T, k, d)
    per_tok = contrib[torch.sort(stok, stable=True).indices].reshape(T, k, d)
    out = torch.zeros((T, d), dtype=dt, device=dev)
    for j in range(k):
        out = out + per_tok[:, j]
    return out


def _moe_dense(p, x, cfg):
    dt = x.dtype
    B, S, d = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.experts_per_token
    cap = int((T * k * cfg.capacity_factor) // E + 1)
    xt = x.reshape(T, d)
    gates, eidx = _route(p["router"], xt, k)
    out = _dispatch_compute_combine(p, xt, gates, eidx, 0, E, cap, dt)
    return out.reshape(B, S, d)


def _moe_ep(p, x, cfg, group):
    dt = x.dtype
    B, S, d = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.experts_per_token
    E_local = p["wi"].shape[0]
    ep = dist.get_world_size(group)
    if E_local * ep != E:
        raise ValueError(f"{E_local} local experts × {ep} ranks != {E} experts")
    cap = int((T * k * cfg.capacity_factor) // E + 1)
    xt = collectives.sum_grads(x.reshape(T, d), group)
    gates, eidx = _route(collectives.sum_grads(p["router"], group), xt, k)
    out = _dispatch_compute_combine(p, xt, gates, eidx, dist.get_rank(group) * E_local,
                                    E_local, cap, dt)
    return collectives.sum_shared(out, group).reshape(B, S, d)


def _moe_on_mesh(p, x, cfg, rules):
    """JAX's `_moe_shardmap` on DTensors: `_moe_ep`'s body on each rank's
    local tensors, its expert group the mesh's `rules["expert"]` dim. The
    router is replicated, `wi` / `wo` sharded on their expert dim over it
    (gathered over any other mesh dim, FSDP's gather), x placed by the
    "batch" rule; the output is the partial outputs' sum, whole on every
    expert rank."""
    mesh = x.device_mesh
    exp_ax = rules["expert"]
    if cfg.n_experts % mesh.size(mesh.mesh_dim_names.index(exp_ax)):
        raise ValueError(f"{cfg.n_experts} experts do not split over mesh dim "
                         f"{exp_ax!r} of {mesh.shape}")
    group = mesh.get_group(exp_ax)
    expert = list(to_placements(mesh, (exp_ax,)))
    xs = list(to_placements(mesh, (rules.get("batch"), None, None)))
    rep = [Replicate()] * mesh.ndim

    def body(router, wi, wo, xl):
        return _moe_ep({"router": router, "wi": wi, "wo": wo}, xl, cfg, group)
    return local_call(body, (p["router"], p["wi"], p["wo"], x), (rep, expert, expert, xs),
                      xs, mesh)


def moe_mlp(p, x, cfg, ep_group=None):
    """x: (B, S, d) → (B, S, d); expert-parallel over `ep_group` when given
    (p then holds this rank's experts, see `local_experts`), or over the
    mesh's expert dim when x is a DTensor and the rules name one (JAX's
    shard_map path)."""
    if ep_group is not None:
        return _moe_ep(p, x, cfg, ep_group)
    rules = get_logical_rules()
    if isinstance(x, DTensor) and rules.get("expert") in x.device_mesh.mesh_dim_names:
        out = _moe_on_mesh(p, x, cfg, rules)
    else:
        out = _moe_dense(p, x, cfg)
    return shard(out, "batch", None, "act_embed")


def local_experts(params, cfg, group):
    """This rank's block of every MoE leaf's experts in a model's parameter
    tree (`wi` and `wo`, expert axis after the group axis; views): rank r
    of ep keeps experts [r·E/ep, (r+1)·E/ep). Every other leaf is kept
    whole."""
    ep, r = dist.get_world_size(group), dist.get_rank(group)
    if cfg.n_experts % ep:
        raise ValueError(f"{cfg.n_experts} experts do not split over {ep} ranks")
    n = cfg.n_experts // ep
    out = dict(params)
    out["groups"] = {
        key: (sub if not key.endswith("_moe") else
              {"router": sub["router"], "wi": sub["wi"][:, r * n:(r + 1) * n],
               "wo": sub["wo"][:, r * n:(r + 1) * n]})
        for key, sub in params["groups"].items()}
    return out


def moe_aux_loss(p, x, cfg):
    """Load-balancing auxiliary loss (Switch-style): E * sum_e f_e * p_e."""
    T = x.shape[0] * x.shape[1]
    logits = (x.float() @ p["router"].float()).reshape(T, -1)
    probs = torch.softmax(logits, dim=-1)
    _, eidx = topk_first(logits, cfg.experts_per_token)
    f = torch.mean(F.one_hot(eidx, cfg.n_experts).sum(1).float(), dim=0)
    pbar = torch.mean(probs, dim=0)
    return cfg.n_experts * torch.sum(f * pbar)
