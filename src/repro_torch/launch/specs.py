"""Abstract arguments and their specs for every (arch × shape) cell (PyTorch
port of `repro/launch/specs.py`): meta tensors (shapes and dtypes, no
storage) in place of JAX's `ShapeDtypeStruct`s, and one spec a leaf (a
tuple of mesh-axis entries, `models/params.pspecs`) in place of its
`PartitionSpec`s. `launch/dryrun.py` places them on a mesh as DTensors
(`models/params.distribute`) and counts one device's step.

Departure: the decode step's position is a Python int in the port
(`models/transformer.decode_step`), so `decode_cell_specs` gives the
position 0, not an abstract int32 scalar; the program is the same for
every position but for which rank's cache shard the new K/V land in.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.models import params as prm
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, ShapeCell
from repro_torch.train import optimizer as opt


def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, B: int, S: int, rules: dict
                ) -> Tuple[dict, dict]:
    """(abstract batch, specs) for a training/prefill batch."""
    b = rules.get("batch")
    if cfg.frontend == "audio":
        ab = {"frames": _sds((B, S, cfg.d_model), torch.float32),
              "labels": _sds((B, S), torch.int32)}
        sp = {"frames": (b, None, None), "labels": (b, None)}
    elif cfg.frontend == "vision":
        St = S - cfg.n_prefix_embeds
        ab = {"tokens": _sds((B, St), torch.int32),
              "patches": _sds((B, cfg.n_prefix_embeds, cfg.d_model), torch.float32),
              "labels": _sds((B, St), torch.int32)}
        sp = {"tokens": (b, None), "patches": (b, None, None), "labels": (b, None)}
    else:
        ab = {"tokens": _sds((B, S), torch.int32),
              "labels": _sds((B, S), torch.int32)}
        sp = {"tokens": (b, None), "labels": (b, None)}
    return ab, sp


def train_accum(cfg: ModelConfig, local_batch: int) -> int:
    """Grad-accum microbatching: target micro-local-batch 2 (1 for wide
    models, whose activations/recurrent states dominate) to bound
    activation memory (DESIGN.md §6)."""
    target = 1 if cfg.d_model >= 4096 else 2
    return max(1, local_batch // target)


def train_cell_specs(cfg: ModelConfig, cell: ShapeCell, rules: dict,
                     multi_pod: bool):
    """Returns (fn, abstract_args, in_specs, out_specs)."""
    from repro_torch.train.train_loop import make_train_step

    dp = 16 * (2 if multi_pod else 1)
    accum = train_accum(cfg, cell.global_batch // dp)
    lr_fn = opt.warmup_cosine(3e-4, warmup=100, total=10_000)
    step_fn = make_train_step(cfg, lr_fn, accum=accum)

    params_abs = T.abstract_params(cfg)
    pspec = T.param_pspecs(cfg, rules)
    opt_abs = opt.AdamWState(_sds((), torch.int32), T.abstract_params(cfg),
                             T.abstract_params(cfg))
    ospec = opt.AdamWState((), pspec, pspec)
    batch_abs, bspec = batch_specs(cfg, cell.global_batch, cell.seq_len, rules)
    metrics_spec = {"loss": (), "grad_norm": (), "lr": ()}
    return (step_fn, (params_abs, opt_abs, batch_abs),
            (pspec, ospec, bspec), (pspec, ospec, metrics_spec))


def _serve_params_abs(cfg: ModelConfig):
    """Serving uses bf16 weights (standard practice; halves weight memory
    vs the fp32 training master copies)."""
    return prm.tree_map(lambda s: _sds(s.shape, torch.bfloat16), T.abstract_params(cfg))


def param_count(cfg: ModelConfig) -> int:
    return sum(math.prod(d.shape) for _, d in prm.leaf_paths(T.model_defs(cfg)))


def serve_rules(cfg: ModelConfig, rules: dict, tp_degree: int = 16) -> dict:
    """Serving sharding policy (§Perf H2): FSDP'ing weights over "data"
    makes every decode step re-all-gather the full parameter set. When
    bf16 weights fit per-device under TP alone, replicate over "data"
    instead; keep FSDP only for models where they don't (mistral-123b)."""
    bf16_per_dev = param_count(cfg) * 2 / tp_degree
    if bf16_per_dev < 8e9:
        rules = dict(rules)
        rules["embed"] = None
    return rules


def prefill_cell_specs(cfg: ModelConfig, cell: ShapeCell, rules: dict):
    params_abs = _serve_params_abs(cfg)
    pspec = T.param_pspecs(cfg, rules)
    batch_abs, bspec = batch_specs(cfg, cell.global_batch, cell.seq_len, rules)
    batch_abs.pop("labels")
    bspec.pop("labels")
    b = rules.get("batch")

    if not cfg.has_decode:
        def encode_step(params, inputs):
            x, _ = T.forward(params, inputs, cfg)
            return T.logits_from_hidden(params, x, cfg)
        out_spec = (b, None, rules.get("vocab"))
        return encode_step, (params_abs, batch_abs), (pspec, bspec), out_spec

    def prefill_step(params, inputs):
        return T.prefill(params, inputs, cfg, max_seq=cell.seq_len)

    cspec = T.cache_pspecs(cfg, cell.global_batch, cell.seq_len, rules)
    out_spec = ((b, None, rules.get("vocab")), cspec)
    return prefill_step, (params_abs, batch_abs), (pspec, bspec), out_spec


def decode_cell_specs(cfg: ModelConfig, cell: ShapeCell, rules: dict):
    from repro_torch.serve.engine import make_serve_step

    params_abs = _serve_params_abs(cfg)
    pspec = T.param_pspecs(cfg, rules)
    B = cell.global_batch
    cache_abs = T.cache_defs(cfg, B, cell.seq_len)
    cspec = T.cache_pspecs(cfg, B, cell.seq_len, rules)
    b = rules.get("batch")
    tok_abs = _sds((B, 1), torch.int32)
    step = make_serve_step(cfg)
    return (step, (params_abs, tok_abs, cache_abs, 0),
            (pspec, (b, None), cspec, None),
            ((b, None), cspec))


def model_flops(cfg: ModelConfig, cell: ShapeCell) -> float:
    """MODEL_FLOPS per step: 6·N·D train (2·N·D fwd-only), N = active params."""
    n_total = 0
    n_expert = 0
    for path, d in prm.leaf_paths(T.model_defs(cfg)):
        n = math.prod(d.shape)
        n_total += n
        if "expert" in d.axes and "router" not in path:
            n_expert += n
    active = n_total - n_expert
    if cfg.n_experts:
        active += n_expert * cfg.experts_per_token / cfg.n_experts
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * active * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * active * tokens
    # decode: one token per sequence
    return 2.0 * active * cell.global_batch
