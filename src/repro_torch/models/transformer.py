"""Model assembly (PyTorch port of `repro/models/transformer.py`):
pattern-grouped blocks, walked over the group axis.

Params layout (JAX's, so that conversion is a copy):
    {"embed": ..., "head": ..., "final_norm": ...,
     "groups": {pos{i}_{name}: leaf stacked over groups}}

`forward`, `prefill` and `decode_step` are plain functions on a tree of
tensors; `Transformer` is the `nn.Module` that owns such a tree (its
submodules and parameter names follow the tree: "groups.pos0_attn.wq").
Decode caches are stacked over groups, as in JAX; `decode_step` updates
them in place and returns them.

Training: where autograd records and `cfg.remat == "block"`, each group
runs under `torch.utils.checkpoint` (JAX wraps its scan body in
`jax.checkpoint`): only the group's input is kept, and its activations are
computed again in the backward pass. `params["groups"]` may also be a list
of per-group trees (the trainer's leaves, `train/train_loop.py`), and
`ep_group` runs the MoE layers expert-parallel (`models/moe.py`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.models import params as prm
from repro_torch.models.attention import (KVCache, attention_block, attn_def,
                                          init_cache_def)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (DTYPES, embed, embed_def, head_def, matmul_w,
                                       local_fn, mlp, mlp_def, rmsnorm, rmsnorm_def,
                                       shard, softmax_xent)
from repro_torch.models.moe import moe_def, moe_mlp
from repro_torch.models.ssm import (MambaState, MLSTMState, SLSTMState, mamba_block,
                                    mamba_def, mamba_state_def, mlstm_block, mlstm_def,
                                    mlstm_state_def, slstm_block, slstm_def,
                                    slstm_state_def)
from repro_torch.utils import Device, resolve_device

MIXER_DEFS = {"attn": attn_def, "mamba": mamba_def,
              "mlstm": mlstm_def, "slstm": slstm_def}
MIXERS = {"mamba": mamba_block, "mlstm": mlstm_block, "slstm": slstm_block}
STATE_DEFS = {"mamba": mamba_state_def, "mlstm": mlstm_state_def,
              "slstm": slstm_state_def}


def _has_mlp(cfg: ModelConfig, pos: int) -> bool:
    return cfg.mlp != "none" and (cfg.d_ff > 0 or pos in cfg.moe_positions)


def group_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """Param defs for ONE group (one pass of block_pattern)."""
    defs: Dict[str, Any] = {}
    for i, kind in enumerate(cfg.block_pattern):
        defs[f"pos{i}_norm1"] = rmsnorm_def(cfg.d_model)
        defs[f"pos{i}_{kind}"] = MIXER_DEFS[kind](cfg)
        if _has_mlp(cfg, i):
            defs[f"pos{i}_norm2"] = rmsnorm_def(cfg.d_model)
            if i in cfg.moe_positions:
                defs[f"pos{i}_moe"] = moe_def(cfg)
            else:
                defs[f"pos{i}_mlp"] = mlp_def(cfg, cfg.d_ff)
    return defs


def model_defs(cfg: ModelConfig) -> Dict[str, Any]:
    stacked = prm.tree_map(
        lambda d: prm.ParamDef((cfg.n_groups,) + d.shape, (None,) + d.axes,
                               d.init, d.scale),
        group_defs(cfg), lambda x: isinstance(x, prm.ParamDef))
    defs = {"groups": stacked, "final_norm": rmsnorm_def(cfg.d_model)}
    if cfg.frontend != "audio":
        defs["embed"] = embed_def(cfg)
    defs["head"] = head_def(cfg)
    if cfg.frontend == "audio":
        defs["in_proj"] = {"w": prm.ParamDef(
            (cfg.d_model, cfg.d_model), ("embed", None))}
    return defs


def abstract_params(cfg: ModelConfig):
    """Meta tensors of the parameter tree (nothing allocated)."""
    return prm.abstract(model_defs(cfg), dtype=DTYPES[cfg.param_dtype])


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: Device = None):
    return prm.init(generator, model_defs(cfg), dtype=DTYPES[cfg.param_dtype],
                    device=device)


def param_pspecs(cfg: ModelConfig, rules: dict):
    return prm.pspecs(model_defs(cfg), rules)


# ----------------------------------------------------------------- caches

def cache_defs(cfg: ModelConfig, batch: int, max_seq: int):
    """Decode-state meta tensors, stacked over groups."""
    out = {}
    for i, kind in enumerate(cfg.block_pattern):
        st = (init_cache_def(cfg, batch, max_seq) if kind == "attn"
              else STATE_DEFS[kind](cfg, batch))
        out[f"pos{i}_{kind}"] = prm.tree_map(
            lambda s: torch.empty((cfg.n_groups,) + tuple(s.shape), dtype=s.dtype,
                                  device="meta"), st)
    return out


def cache_pspecs(cfg: ModelConfig, batch: int, max_seq: int, rules: dict):
    """Specs of the decode cache (KV seq-sharded; states sharded on their
    wide dim), JAX's leaf for leaf."""
    r = rules.get
    out = {}
    for i, kind in enumerate(cfg.block_pattern):
        if kind == "attn":
            kv = (None, r("batch"), r("kv_seq"), None, None)
            out[f"pos{i}_{kind}"] = KVCache(kv, kv)
        elif kind == "mamba":
            out[f"pos{i}_{kind}"] = MambaState((None, r("batch"), None, r("mlp")),
                                               (None, r("batch"), r("mlp"), None))
        elif kind == "mlstm":
            out[f"pos{i}_{kind}"] = MLSTMState(
                (None, r("batch"), r("heads"), r("head"), None),
                (None, r("batch"), r("heads"), None),
                (None, r("batch"), r("heads")))
        else:  # slstm — (head × block) sub-heads sharded over "shead"
            s = (None, r("batch"), r("shead"), None)
            out[f"pos{i}_{kind}"] = SLSTMState(s, s, s, s)
    return out


# ---------------------------------------------------------------- forward

def cast_big_params(groups, cfg: ModelConfig):
    """JAX's `_cast_big_params`: f32 leaves with ndim ≥ 3 and more than 1e6
    elements in the compute dtype. Every product casts its weight to the
    compute dtype anyway, so this moves bytes, not values; a leaf already
    cast is returned as it is. Small leaves (norm scales, gates, SSM
    A/conv) stay f32."""
    dt = DTYPES[cfg.compute_dtype]
    if dt == torch.float32:
        return groups
    return prm.tree_map(
        lambda a: a.to(dt) if (a.dtype == torch.float32 and a.dim() >= 3
                               and a.numel() > 1_000_000) else a, groups)


def _group(groups, gi: int):
    """Group gi's parameters (views into the stacked leaves)."""
    return prm.tree_map(lambda a: a[gi], groups)


def _unstack(groups, n_groups: int):
    """The stacked group tree as n_groups per-group trees of views: one
    unbind a leaf, whose backward is one stack (a slice each would add a
    zero-filled stack a group)."""
    parts = prm.tree_map(lambda a: a.unbind(0), groups, lambda a: isinstance(a, torch.Tensor))
    return [prm.tree_map(lambda t: t[gi], parts, lambda t: isinstance(t, tuple))
            for gi in range(n_groups)]


def _cast_group(gp, cfg: ModelConfig, n_groups: int):
    """`cast_big_params` on one group's slices of a stack of n_groups: the
    same leaves (ndim ≥ 3 and more than 1e6 elements in the stack) in the
    compute dtype."""
    dt = DTYPES[cfg.compute_dtype]
    if dt == torch.float32:
        return gp
    return prm.tree_map(
        lambda a: a.to(dt) if (a.dtype == torch.float32 and a.dim() >= 2
                               and a.numel() * n_groups > 1_000_000) else a, gp)


def _apply_group(gp, x, positions, cfg, mask_mode, states, cache_index,
                 ep_group=None):
    """One pass of block_pattern. states: dict pos{i}_{kind} → state or None."""
    new_states = {}
    for i, kind in enumerate(cfg.block_pattern):
        h = rmsnorm(gp[f"pos{i}_norm1"], x, cfg.norm_eps)
        key = f"pos{i}_{kind}"
        st = states.get(key) if states else None
        if kind == "attn":
            mix, new_st = attention_block(gp[key], h, positions, cfg,
                                          mask_mode, st, cache_index)
        else:
            mix, new_st = MIXERS[kind](gp[key], h, cfg, st)
        x = x + mix
        new_states[key] = new_st
        if _has_mlp(cfg, i):
            h2 = rmsnorm(gp[f"pos{i}_norm2"], x, cfg.norm_eps)
            if i in cfg.moe_positions:
                x = x + moe_mlp(gp[f"pos{i}_moe"], h2, cfg, ep_group)
            else:
                x = x + mlp(gp[f"pos{i}_mlp"], h2, cfg)
        x = shard(x, "batch", None, "act_embed")
    return x, new_states


def _block(gp, x, positions, cfg, mask_mode, n_groups, ep_group):
    """One group in sequence mode, its big leaves cast first."""
    return _apply_group(_cast_group(gp, cfg, n_groups), x, positions, cfg,
                        mask_mode, None, None, ep_group)


def _embed_inputs(params, inputs, cfg: ModelConfig):
    """Returns (x (B,S,d), mask_mode)."""
    dt = DTYPES[cfg.compute_dtype]
    if cfg.frontend == "audio":
        x = matmul_w(inputs["frames"].to(dt), params["in_proj"]["w"])
        return shard(x, "batch", None, "act_embed"), "full"
    tok_emb = embed(params["embed"], inputs["tokens"], cfg)
    if cfg.frontend == "vision":
        x = torch.cat([inputs["patches"].to(dt), tok_emb], dim=1)
        return shard(x, "batch", None, "act_embed"), "prefix"
    return tok_emb, "causal" if cfg.causal else "full"


def _positions(B: int, S: int, device):
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def _run(params, inputs, cfg: ModelConfig, ep_group=None):
    """Embed, every group, final norm → (hidden (B,S,d), per-group states)."""
    x, mask_mode = _embed_inputs(params, inputs, cfg)
    positions = _positions(x.shape[0], x.shape[1], x.device)
    groups = params["groups"]
    if isinstance(groups, dict):
        groups = _unstack(groups, cfg.n_groups)
    remat = cfg.remat == "block" and torch.is_grad_enabled()
    states = []
    for gp in groups:
        args = (gp, x, positions, cfg, mask_mode, len(groups), ep_group)
        x, st = (checkpoint(_block, *args, use_reentrant=False) if remat
                 else _block(*args))
        states.append(st)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), states


def forward(params, inputs, cfg: ModelConfig, ep_group=None):
    """Sequence-mode forward. Returns (hidden (B,S,d), None): JAX's tuple,
    whose states slot (`collect_states`, which nothing calls) is not
    ported."""
    return _run(params, inputs, cfg, ep_group)[0], None


def _stack(per_group):
    """Group states (tuples of tensors) → one tuple of tensors stacked on a
    leading group axis."""
    return type(per_group[0])(*(torch.stack(leaves) for leaves in zip(*per_group)))


def logits_from_hidden(params, x, cfg: ModelConfig):
    logits = matmul_w(x, params["head"]["w"])
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return shard(logits, "batch", None, "vocab")


def loss_fn(params, batch, cfg: ModelConfig, ep_group=None):
    """Next-token (causal) or frame-classification (encoder) loss."""
    x, _ = forward(params, batch, cfg, ep_group)
    logits = logits_from_hidden(params, x, cfg)
    if cfg.frontend == "vision":                # loss over text positions only
        logits = logits[:, cfg.n_prefix_embeds:, :]
    loss = torch.mean(softmax_xent(logits, batch["labels"], cfg.vocab_size))
    # on a mesh, the whole scalar on every rank (JAX's is replicated): the
    # backward pass then starts from a plain 1.0, whatever the partial
    # placement the mean left (a partial scalar's seed is version-dependent)
    return loss.full_tensor() if isinstance(loss, DTensor) else loss


# ------------------------------------------------------------------ serve

def prefill(params, inputs, cfg: ModelConfig, max_seq: int):
    """Run the full prompt; returns (last-token logits, decode caches).

    Attention layers' segment K/V (after RoPE) are written into max_seq
    buffers of the cache dtype (zeros past the prompt); recurrent states
    are stacked over groups as they come out.
    """
    x, states = _run(params, inputs, cfg)
    logits = logits_from_hidden(params, x[:, -1:, :], cfg)
    cdt = DTYPES[cfg.cache_dtype]
    caches = {}
    for key in states[0]:
        per_group = [s[key] for s in states]
        if key.endswith("_attn"):
            pad = (0, 0, 0, 0, 0, max_seq - per_group[0].k.shape[1])

            def pad_stack(*ts):
                return (torch.stack([F.pad(t.to(cdt), pad) for t in ts]),)
            # on DTensors each rank pads its own (batch, kv_heads) shard
            ax = ("batch", None, "kv_heads", None)
            caches[key] = KVCache(*(
                shard(local_fn(pad_stack, [kv[j] for kv in per_group], [ax] * len(per_group),
                               [(None,) + ax])[0],
                      None, "batch", "kv_seq", "kv_heads", None) for j in range(2)))
        else:
            caches[key] = _stack(per_group)
    return logits, caches


def decode_step(params, token, caches, index: int, cfg: ModelConfig):
    """One decode step. token (B, 1) int; index: the position (a Python
    int, so nothing waits on the device).

    caches: dict pos{i}_{kind} → state stacked over groups (leading G),
    updated in place. Returns (logits (B, 1, vocab), caches).
    """
    x = embed(params["embed"], token, cfg)
    positions = torch.full(token.shape, index, dtype=torch.int32, device=token.device)
    groups = cast_big_params(params["groups"], cfg)
    for gi in range(cfg.n_groups):
        st = {key: type(c)(*(leaf[gi] for leaf in c)) for key, c in caches.items()}
        x, new_st = _apply_group(_group(groups, gi), x, positions, cfg, "causal",
                                 st, index)
        for key, new in new_st.items():
            for view, leaf in zip(st[key], new):
                if leaf is not view:
                    view.copy_(_placed_like(leaf, view))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_from_hidden(params, x, cfg), caches


def _placed_like(t, ref):
    """t redistributed to ref's placements where both are DTensors (an
    in-place copy cannot move ref's own)."""
    if isinstance(ref, DTensor) and isinstance(t, DTensor) and t.placements != ref.placements:
        return t.redistribute(ref.device_mesh, ref.placements)
    return t


# ----------------------------------------------------------------- module

def _to_module(tree) -> nn.Module:
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v) for k, v in tree.items()})
    return nn.ModuleDict({k: _to_module(v) for k, v in tree.items()})


def _to_tree(mod: nn.Module):
    if isinstance(mod, nn.ParameterDict):
        return dict(mod.items())
    return {k: _to_tree(v) for k, v in mod.items()}


class Transformer(nn.Module):
    """The parameter tree of `cfg` as an `nn.Module`, in JAX's layouts.

    Built from `init_params` (seeded by `generator`) unless `params` (a
    tree of tensors, e.g. one converted from the JAX package) is given.
    Runs on `device`: CUDA unless the caller passes "cpu".
    """

    def __init__(self, cfg: ModelConfig, params: Optional[dict] = None, *,
                 generator: Optional[torch.Generator] = None,
                 device: Device = None):
        super().__init__()
        dev = resolve_device(device)
        if params is None:
            gen = generator if generator is not None else torch.Generator().manual_seed(0)
            params = init_params(gen, cfg, device=dev)
        self.cfg = cfg
        for key, sub in params.items():
            self.add_module(key, _to_module(prm.tree_map(lambda a: a.to(dev), sub)))

    def param_tree(self) -> dict:
        """The parameters as the nested dict the functions take."""
        return {k: _to_tree(m) for k, m in self.named_children()}

    def forward(self, inputs: dict):
        return forward(self.param_tree(), inputs, self.cfg)

    def loss(self, batch: dict):
        return loss_fn(self.param_tree(), batch, self.cfg)

    def prefill(self, inputs: dict, max_seq: int):
        return prefill(self.param_tree(), inputs, self.cfg, max_seq)

    def decode_step(self, token, caches, index: int):
        return decode_step(self.param_tree(), token, caches, index, self.cfg)
