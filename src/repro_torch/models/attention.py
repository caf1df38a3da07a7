"""GQA attention (PyTorch port of `repro/models/attention.py`): blockwise
(memory-bounded) prefill / train, cached decode.

Prefill expands K/V to the query heads and runs JAX's online-softmax
blockwise attention: one (q chunk × kv chunk) tile at a time, the running
max, denominator and accumulator in f32, masked logits at NEG_INF. Decode
keeps the cache in grouped (g KV heads) form and attends over the whole
cache with the positions past the index masked, as JAX does. The one
departure: decode writes the new position into the cache in place
(`k_cache[:, index] = k`) where JAX selects it with a one-hot `where` over
the whole cache (a write GSPMD can partition); the values are the same.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models.layers import DTYPES, matmul_w, rope
from repro_torch.models.params import ParamDef

NEG_INF = -1e30


def attn_def(cfg) -> dict:
    d, h, g, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": ParamDef((d, h, hd), ("embed", "heads", "head")),
        "wk": ParamDef((d, g, hd), ("embed", "kv_heads", "head")),
        "wv": ParamDef((d, g, hd), ("embed", "kv_heads", "head")),
        "wo": ParamDef((h, hd, d), ("heads", "head", "embed")),
    }


def _expand_kv(k, h: int):
    """(B, S, g, hd) → (B, S, h, hd): KV head j serves query heads
    j·m … j·m+m−1 (`jnp.repeat`'s order, m = h/g)."""
    return torch.repeat_interleave(k, h // k.shape[2], dim=2)


def _mask(qpos, kpos, mode: str, n_prefix: int = 0):
    """qpos (Sq,), kpos (Sk,) → bool (Sq, Sk) True = attend."""
    if mode == "full":
        return torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                          device=qpos.device)
    causal = kpos[None, :] <= qpos[:, None]
    if mode == "prefix":
        return causal | (kpos[None, :] < n_prefix)
    return causal


def _masked_f32(logits, msk):
    """JAX's `where(msk, logits.astype(f32), NEG_INF)`."""
    return logits.float().masked_fill(~msk, NEG_INF)


def blockwise_attention(q, k, v, mask_mode: str, n_prefix: int = 0,
                        q_chunk: int = 2048, kv_chunk: int = 2048):
    """Online-softmax blockwise attention.

    q (B, S, h, hd); k, v (B, S, h, hd) — already expanded. Returns
    (B, S, h, hd). S must be a multiple of both chunks when S > q_chunk.
    """
    B, S, h, hd = q.shape
    scale = hd ** -0.5
    dev = q.device
    if S <= q_chunk:  # single tile: plain fused attention
        pos = torch.arange(S, device=dev)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        w = torch.softmax(_masked_f32(logits, _mask(pos, pos, mask_mode, n_prefix)),
                          dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", w, v)

    nq, nk = S // q_chunk, S // kv_chunk
    out = torch.empty_like(q)
    for qi in range(nq):
        qblk = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        qpos = qi * q_chunk + torch.arange(q_chunk, device=dev)
        m_run = torch.full((B, h, q_chunk), NEG_INF, dtype=torch.float32, device=dev)
        l_run = torch.zeros((B, h, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, h, q_chunk, hd), dtype=torch.float32, device=dev)
        for kj in range(nk):
            sl = slice(kj * kv_chunk, (kj + 1) * kv_chunk)
            kpos = kj * kv_chunk + torch.arange(kv_chunk, device=dev)
            logits = (torch.einsum("bqhd,bkhd->bhqk", qblk, k[:, sl])
                      * scale).float()
            logits = _masked_f32(logits, _mask(qpos, kpos, mask_mode, n_prefix))
            m_new = torch.maximum(m_run, torch.amax(logits, dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + torch.sum(p, dim=-1)
            acc = (acc * corr[..., None]
                   + torch.einsum("bhqk,bkhd->bhqd", p.to(q.dtype),
                                  v[:, sl]).float())
            m_run = m_new
        o = acc / torch.clamp(l_run, min=1e-30)[..., None]
        out[:, qi * q_chunk:(qi + 1) * q_chunk] = o.transpose(1, 2).to(q.dtype)
    return out


class KVCache(NamedTuple):
    k: torch.Tensor     # (B, Smax, g, hd)
    v: torch.Tensor


def attention_block(p, x, positions, cfg, mask_mode: str = "causal",
                    cache: Optional[KVCache] = None,
                    cache_index: Optional[int] = None):
    """Full attention sub-block (projections + attention + out-proj).

    Prefill/train: cache is None → returns (out, KVCache of this segment).
    Decode: cache given, x is (B, 1, d), cache_index (a Python int) the
    current position; the new K/V are written into `cache` in place and
    the same cache is returned.
    """
    dt = x.dtype
    h, g, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = matmul_w(x, p["wq"])
    k = matmul_w(x, p["wk"])
    v = matmul_w(x, p["wv"])
    if mask_mode != "full":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    if cache is None:
        out = blockwise_attention(q, _expand_kv(k, h), _expand_kv(v, h),
                                  mask_mode, cfg.n_prefix_embeds)
        new_cache = KVCache(k, v)
    else:
        # decode: q (B, 1, h, hd); cache (B, Smax, g, hd)
        kc, vc = cache
        kc[:, cache_index] = k[:, 0].to(kc.dtype)
        vc[:, cache_index] = v[:, 0].to(vc.dtype)
        B = q.shape[0]
        qg = q.reshape(B, 1, g, h // g, hd)
        logits = (torch.einsum("bqgmk,bsgk->bgmqs", qg, kc.to(dt))
                  * hd ** -0.5).float()
        valid = torch.arange(kc.shape[1], device=x.device) <= cache_index
        w = torch.softmax(logits.masked_fill(~valid, NEG_INF), dim=-1)
        out = torch.einsum("bgmqs,bsgk->bqgmk", w.to(dt), vc.to(dt))
        out = out.reshape(B, 1, h, hd)
        new_cache = cache

    return matmul_w(out, p["wo"], n_in=2), new_cache


def init_cache_def(cfg, batch: int, max_seq: int):
    """Meta tensors of one attention layer's KV cache."""
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.hd)
    cdt = DTYPES[cfg.cache_dtype]
    return KVCache(torch.empty(shape, dtype=cdt, device="meta"),
                   torch.empty(shape, dtype=cdt, device="meta"))
