"""Shared model layers (PyTorch port of `repro/models/layers.py`): norms,
MLPs, rotary embeddings, embeddings and the cross entropy.

All functions are pure; parameters arrive as dict trees of tensors in the
JAX package's layouts (built in transformer.py from ParamDefs). Each
product casts its weight to the activation's dtype, as JAX's einsums do.
JAX's logical sharding (`shard`, the mesh rules) has no torch object and
is left out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamDef

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def gelu(x):
    """`jax.nn.gelu`'s default, the tanh approximation (torch's default is
    the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def matmul_w(x, w, n_in: int = 1):
    """x (..., *w.shape[:n_in]) · w → (..., *w.shape[n_in:]) in x's dtype:
    JAX's `einsum("...d,d...->...", x, w.astype(x.dtype))` as one matmul."""
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
    return p["table"][tokens].to(DTYPES[cfg.compute_dtype])


def unembed(p, x, cfg):
    """Final projection to (padded) vocab logits through the embedding."""
    logits = x @ p["table"].to(x.dtype).T
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def head_def(cfg) -> dict:
    """Separate output head (used when not tying to the embedding)."""
    return {"w": ParamDef((cfg.d_model, cfg.vocab_padded),
                          ("embed", "vocab"))}


def softmax_xent(logits, labels, vocab_size: int):
    """Cross entropy over the (padded) vocab dim; padded ids never occur in
    labels. fp32 accumulation."""
    logits = logits.float()
    m = torch.amax(logits, dim=-1, keepdim=True)
    shifted = logits - m.detach()
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1))
    gold = torch.gather(shifted, -1, labels[..., None].long())[..., 0]
    return lse - gold
