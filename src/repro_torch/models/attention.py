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
On a cache sharded over its sequence ("kv_seq"), the write lands in the
one rank's shard that holds the position, on its local tensor.

Sharding: `shard` constrains q, the expanded K/V and the segment cache
(heads over "model" in prefill, the cache's sequence over "model") and
the block's output, where JAX does. On DTensors the blockwise attention
runs on each rank's (batch, heads) shard (`local_fn`), and decode over a
sequence-sharded cache merges each rank's partial softmax
(`_attend_cache`) — what GSPMD makes of JAX's plain softmax there.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.launch.mesh import local_range
from repro_torch.models.layers import DTYPES, local_call, local_fn, matmul_w, rope, shard
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
        q = shard(q, "batch", None, "heads", None)
        kf = shard(_expand_kv(k, h), "batch", None, "heads", None)
        vf = shard(_expand_kv(v, h), "batch", None, "heads", None)
        ax = ("batch", None, "heads", None)
        out, = local_fn(lambda *a: (blockwise_attention(*a, mask_mode, cfg.n_prefix_embeds),),
                        (q, kf, vf), (ax, ax, ax), (ax,))
        new_cache = KVCache(shard(k, "batch", "kv_seq", "kv_heads", None),
                            shard(v, "batch", "kv_seq", "kv_heads", None))
    else:
        # decode: q (B, 1, h, hd); cache (B, Smax, g, hd)
        kc, vc = cache
        _write_at(kc, k, cache_index)
        _write_at(vc, v, cache_index)
        kc = shard(kc, "batch", "kv_seq", "kv_heads", None)
        vc = shard(vc, "batch", "kv_seq", "kv_heads", None)
        if isinstance(kc, DTensor):
            out = _attend_cache_sharded(q, kc, vc, cache_index)
        else:
            out = _attend_cache(q, kc, vc, cache_index)
        new_cache = cache

    y = matmul_w(out, p["wo"], n_in=2)
    return shard(y, "batch", None, "act_embed"), new_cache


def _attend_cache(q, kc, vc, index: int, lo: int = 0, groups=()):
    """q (B, 1, h, hd) against the cache's positions ≤ index → (B, 1, h, hd).
    The cache holds positions lo, lo+1, ...; with `groups` (the process
    groups that shard its sequence, the local shards given) the softmax
    is merged across them: the max by an all-reduce, then the
    denominators and the weighted values by sums (the distributed
    online-softmax merge GSPMD makes of JAX's plain softmax)."""
    B, _, h, hd = q.shape
    g, dt = kc.shape[2], q.dtype
    qg = q.reshape(B, 1, g, h // g, hd)
    logits = (torch.einsum("bqgmk,bsgk->bgmqs", qg, kc.to(dt)) * hd ** -0.5).float()
    valid = torch.arange(lo, lo + kc.shape[1], device=q.device) <= index
    logits = logits.masked_fill(~valid, NEG_INF)
    if not groups:
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bgmqs,bsgk->bqgmk", w.to(dt), vc.to(dt))
        return out.reshape(B, 1, h, hd)
    m = torch.amax(logits, dim=-1, keepdim=True)
    for grp in groups:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=grp)
    p = torch.exp(logits - m)
    den = torch.sum(p, dim=-1)                                  # (B,g,m,1)
    out = torch.einsum("bgmqs,bsgk->bqgmk", p.to(dt), vc.to(dt))
    for grp in groups:
        dist.all_reduce(den, group=grp)
        dist.all_reduce(out, group=grp)
    out = out / den.permute(0, 3, 1, 2)[..., None].to(dt)
    return out.reshape(B, 1, h, hd)


def _attend_cache_sharded(q, kc, vc, index: int):
    """`_attend_cache` on DTensors: each rank attends over its own shard of
    the cache's sequence, merged across the mesh dims that shard it."""
    mesh, pl = kc.device_mesh, list(kc.placements)
    seq = [m for m, p in enumerate(pl) if p == Shard(1)]
    lo = local_range(kc.shape, mesh, pl)[0][1]
    groups = [mesh.get_group(m) for m in seq]
    out_pl = [p if m not in seq and p == Shard(0) else Replicate()
              for m, p in enumerate(pl)]
    return local_call(lambda a, b, c: _attend_cache(a, b, c, index, lo, groups),
                      (q, kc, vc), (out_pl, pl, pl), out_pl, mesh)


def _write_at(cache, new, index: int):
    """cache[:, index] = new[:, 0] in place. A DTensor cache is written on
    its local tensor by the rank whose shard holds `index` (new placed
    like the cache but whole along the sequence)."""
    if not isinstance(cache, DTensor):
        cache[:, index] = new[:, 0].to(cache.dtype)
        return
    mesh, pl = cache.device_mesh, cache.placements
    off, shape = local_range(cache.shape, mesh, pl)
    whole = [Replicate() if p == Shard(1) else p for p in pl]
    if not isinstance(new, DTensor):
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim, run_check=False)
    local = new.redistribute(mesh, whole).to_local()
    if off[1] <= index < off[1] + shape[1]:
        cache.to_local()[:, index - off[1]] = local[:, 0].to(cache.dtype)


def init_cache_def(cfg, batch: int, max_seq: int):
    """Meta tensors of one attention layer's KV cache."""
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.hd)
    cdt = DTYPES[cfg.cache_dtype]
    return KVCache(torch.empty(shape, dtype=cdt, device="meta"),
                   torch.empty(shape, dtype=cdt, device="meta"))
