"""Recurrent mixers (PyTorch port of `repro/models/ssm.py`): Mamba (S6
selective SSM), mLSTM and sLSTM (xLSTM).

All three expose the same interface as attention_block:
    out, new_state = <block>(params, x, cfg, state=None)
state=None → sequence mode (train/prefill), a loop over time with a
carried recurrent state; returns the final state for decode handoff.
state given + S==1 → single decode step.

JAX's `chunked_scan` (a two-level scan that checkpoints per chunk for the
backward pass) becomes a plain time loop: its chunking only saves memory
under autodiff. mLSTM's chunkwise form is ported as it is (cumsum /
cummax over time) and taken under JAX's rule (S % 64 == 0 and S >= 128).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import DTYPES, local_fn, matmul_w, shard
from repro_torch.models.params import ParamDef


def softplus(x):
    """`jax.nn.softplus`: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# ------------------------------------------------------------------- Mamba

class MambaState(NamedTuple):
    conv: torch.Tensor   # (B, W-1, di) last conv inputs
    h: torch.Tensor      # (B, di, N) SSM state


def mamba_def(cfg) -> dict:
    d, di, N, W = cfg.d_model, cfg.d_inner, cfg.ssm_state_dim, cfg.ssm_conv_width
    dt_rank = max(d // 16, 1)
    return {
        "in_proj": ParamDef((d, 2, di), ("embed", None, "mlp")),
        "conv_w": ParamDef((W, di), (None, "mlp"), scale=1.0),
        "conv_b": ParamDef((di,), ("mlp",), init="zeros"),
        "x_proj": ParamDef((di, dt_rank + 2 * N), ("mlp", None)),
        "dt_w": ParamDef((dt_rank, di), (None, "mlp")),
        "dt_b": ParamDef((di,), ("mlp",), init="zeros"),
        "A_log": ParamDef((di, N), ("mlp", None), init="ssm_a"),
        "D": ParamDef((di,), ("mlp",), init="ones"),
        "out_proj": ParamDef((di, d), ("mlp", "embed")),
    }


def mamba_block(p, x, cfg, state: Optional[MambaState] = None):
    dt_ = x.dtype
    B, S, d = x.shape
    di, N, W = cfg.d_inner, cfg.ssm_state_dim, cfg.ssm_conv_width
    dt_rank = max(d // 16, 1)

    xz = matmul_w(x, p["in_proj"])
    xin, z = xz[:, :, 0, :], xz[:, :, 1, :]                     # (B, S, di)
    xin = shard(xin, "batch", None, "mlp")

    # causal depthwise conv over time
    if state is None:
        pad = torch.zeros((B, W - 1, di), dtype=dt_, device=x.device)
    else:
        pad = state.conv.to(dt_)
    xpad = torch.cat([pad, xin], dim=1)                         # (B, S+W-1, di)
    conv = sum(xpad[:, i:i + S, :] * p["conv_w"][i].to(dt_) for i in range(W))
    xin_c = F.silu(conv + p["conv_b"].to(dt_))
    new_conv = xpad[:, S:, :]                                   # last W-1 inputs

    proj = matmul_w(xin_c, p["x_proj"])
    dt_raw = matmul_w(proj[..., :dt_rank], p["dt_w"]) + p["dt_b"].to(dt_)
    delta = softplus(dt_raw.float())                            # (B, S, di)
    Bm = proj[..., dt_rank:dt_rank + N].float()                 # (B, S, N)
    Cm = proj[..., dt_rank + N:].float()
    A = -torch.exp(p["A_log"].float())                          # (di, N)

    h = (torch.zeros((B, di, N), dtype=torch.float32, device=x.device)
         if state is None else state.h.float())
    decay = torch.exp(delta[..., None] * A)                     # (B, S, di, N)
    inp = (delta * xin_c.float())[..., None] * Bm[:, :, None, :]
    y, h = local_fn(_mamba_scan, (h, decay, inp, Cm),
                    (("batch", "mlp", None), ("batch", None, "mlp", None),
                     ("batch", None, "mlp", None), ("batch", None, None)),
                    (("batch", None, "mlp"), ("batch", "mlp", None)))
    y = y.to(dt_)                                               # (B, S, di)
    y = y + xin_c * p["D"].to(dt_)
    y = y * F.silu(z)
    out = matmul_w(y, p["out_proj"])
    cdt = DTYPES[cfg.cache_dtype]
    return shard(out, "batch", None, "act_embed"), MambaState(new_conv.to(cdt), h.to(cdt))


def _mamba_scan(h, decay, inp, Cm):
    """The selective scan over time → (y (B, S, di), final h)."""
    ys = []
    for t in range(decay.shape[1]):
        h = h * decay[:, t] + inp[:, t]
        ys.append(torch.einsum("bin,bn->bi", h, Cm[:, t]))
    return torch.stack(ys, dim=1), h


def mamba_state_def(cfg, batch: int):
    cdt = DTYPES[cfg.cache_dtype]
    return MambaState(
        torch.empty((batch, cfg.ssm_conv_width - 1, cfg.d_inner), dtype=cdt,
                    device="meta"),
        torch.empty((batch, cfg.d_inner, cfg.ssm_state_dim), dtype=cdt,
                    device="meta"))


# ------------------------------------------------------------------- mLSTM

class MLSTMState(NamedTuple):
    C: torch.Tensor      # (B, H, dv, dk) matrix memory
    n: torch.Tensor      # (B, H, dk) normalizer
    m: torch.Tensor      # (B, H) log-space stabilizer


def mlstm_def(cfg) -> dict:
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    return {
        "wq": ParamDef((d, H, hd), ("embed", "heads", None)),
        "wk": ParamDef((d, H, hd), ("embed", "heads", None)),
        "wv": ParamDef((d, H, hd), ("embed", "heads", "head")),
        "wi": ParamDef((d, H), ("embed", "heads")),
        "wf": ParamDef((d, H), ("embed", "heads")),
        "wog": ParamDef((d, H, hd), ("embed", "heads", "head")),
        "wo": ParamDef((H, hd, d), ("heads", "head", "embed")),
    }


MLSTM_CHUNK = 64


def _mlstm_sequential(q, k, v, ig, fg, C0, n0, m0, S):
    """Reference per-step recurrence (used for decode and as the oracle for
    the chunkwise form)."""
    C, n, m = C0, n0, m0
    hs = []
    for t in range(S):
        qt, kt, vt = q[:, t].float(), k[:, t].float(), v[:, t].float()
        it, ft = ig[:, t], fg[:, t]
        logf = F.logsigmoid(ft)                                 # (B, H)
        m_new = torch.maximum(logf + m, it)
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(logf + m - m_new)
        C = (f_p[..., None, None] * C
             + i_p[..., None, None] * (vt[..., :, None] * kt[..., None, :]))
        n = f_p[..., None] * n + i_p[..., None] * kt
        num = torch.einsum("bhvk,bhk->bhv", C, qt)
        den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n, qt)),
                            torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=1), (C, n, m)


def _mlstm_chunkwise(q, k, v, ig, fg, C0, n0, m0, S, L: int = MLSTM_CHUNK):
    """Chunkwise-parallel mLSTM — the exact log-space reformulation of the
    sequential recurrence: intra-chunk terms are (L×L) products, the
    (dv×dk) matrix state is materialized once per chunk.

    With A_t = Σ_{u≤t} log σ(f_u) (within chunk) and b_t = ĩ_t, the
    stabilizer m_t = max(logσ(f_t)+m_{t-1}, b_t) unrolls to
    m_t = max(m_prev + A_t, A_t + cummax_s≤t(b_s − A_s)).
    """
    B, _, H, hd = q.shape
    nch = S // L

    def to_chunks(t):
        if t.dim() == 4:  # (B,S,H,hd) → (nch, B, H, L, hd)
            return t.reshape(B, nch, L, H, hd).permute(1, 0, 3, 2, 4)
        return t.reshape(B, nch, L, H).permute(1, 0, 3, 2)     # (nch,B,H,L)

    qc, kc, vc = (to_chunks(t.float()) for t in (q, k, v))
    ac = to_chunks(F.logsigmoid(fg))
    bc = to_chunks(ig)
    tril = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))

    Cp, np_, mp = C0, n0, m0
    hs = []
    for c in range(nch):
        qb, kb, vb, a, b = qc[c], kc[c], vc[c], ac[c], bc[c]  # (B,H,L,*)
        A = torch.cumsum(a, dim=-1)                             # (B,H,L)
        m = torch.maximum(mp[..., None] + A,
                          A + torch.cummax(b - A, dim=-1).values)
        E = A + mp[..., None] - m                               # ≤ 0
        D = (A[..., :, None] - A[..., None, :]
             + b[..., None, :] - m[..., :, None])               # (B,H,L,L)
        W = torch.where(tril, torch.exp(D), 0.0)
        qk = qb @ kb.transpose(-1, -2)
        num = (W * qk) @ vb + torch.exp(E)[..., None] * (qb @ Cp.transpose(-1, -2))
        nvec = W @ kb + torch.exp(E)[..., None] * np_[..., None, :]
        den = torch.maximum(torch.abs(torch.sum(nvec * qb, dim=-1)),
                            torch.exp(-m))
        hs.append(num / den[..., None])                         # (B,H,L,dv)
        # chunk-end state
        mL = m[..., -1]
        AL = A[..., -1:]
        w_end = torch.exp(AL - A + b - mL[..., None])           # (B,H,L)
        decay = torch.exp(AL[..., 0] + mp - mL)                 # (B,H)
        Cp = ((w_end[..., None] * vb).transpose(-1, -2) @ kb
              + decay[..., None, None] * Cp)
        np_ = (w_end[..., None] * kb).sum(-2) + decay[..., None] * np_
        mp = mL
    # nch × (B, H, L, dv) → (B, S, H, dv)
    h = torch.stack(hs, dim=1).permute(0, 1, 3, 2, 4).reshape(B, S, H, hd)
    return h, (Cp, np_, mp)


def _flat(out):
    hs, (C, n, m) = out
    return hs, C, n, m


def mlstm_block(p, x, cfg, state: Optional[MLSTMState] = None):
    dt_ = x.dtype
    B, S, d = x.shape
    H, hd = cfg.n_heads, cfg.hd
    q = matmul_w(x, p["wq"]) * hd ** -0.5
    k = matmul_w(x, p["wk"]) * hd ** -0.5
    v = shard(matmul_w(x, p["wv"]), "batch", None, "heads", "head")
    ig = matmul_w(x, p["wi"]).float()
    fg = matmul_w(x, p["wf"]).float()
    og = torch.sigmoid(matmul_w(x, p["wog"]))

    if state is None:
        C0 = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
        n0 = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
        m0 = torch.full((B, H), -1e30, dtype=torch.float32, device=x.device)
    else:
        C0, n0, m0 = state.C.float(), state.n.float(), state.m.float()

    run = (_mlstm_chunkwise if S % MLSTM_CHUNK == 0 and S >= 2 * MLSTM_CHUNK
           else _mlstm_sequential)
    qk, v_, g_ = ("batch", None, "heads", None), ("batch", None, "heads", "head"), \
        ("batch", None, "heads")
    st = (("batch", "heads", "head", None), ("batch", "heads", None), ("batch", "heads"))
    hs, CT, nT, mT = local_fn(lambda *a: _flat(run(*a, S)), (q, k, v, ig, fg, C0, n0, m0),
                              (qk, qk, v_, g_, g_) + st, (v_,) + st)
    h = hs.to(dt_) * og
    out = matmul_w(h, p["wo"], n_in=2)
    cdt = DTYPES[cfg.cache_dtype]
    return shard(out, "batch", None, "act_embed"), MLSTMState(CT.to(cdt), nT.to(cdt), mT.float())


def mlstm_state_def(cfg, batch: int):
    H, hd = cfg.n_heads, cfg.hd
    cdt = DTYPES[cfg.cache_dtype]
    return MLSTMState(torch.empty((batch, H, hd, hd), dtype=cdt, device="meta"),
                      torch.empty((batch, H, hd), dtype=cdt, device="meta"),
                      torch.empty((batch, H), dtype=torch.float32, device="meta"))


# ------------------------------------------------------------------- sLSTM

class SLSTMState(NamedTuple):
    c: torch.Tensor      # (B, H, du)
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor


SLSTM_BLOCKS = 4     # block-diagonal recurrence, 4 blocks/head (xLSTM paper)


def _slstm_dims(cfg):
    """Effective (sub-)heads: H × SLSTM_BLOCKS independent recurrences, each
    a scalar LSTM over bs units (the block-diagonal R)."""
    H = cfg.n_heads
    du = cfg.d_model // H
    nb = SLSTM_BLOCKS if du % SLSTM_BLOCKS == 0 else 1
    return H * nb, du // nb


def slstm_def(cfg) -> dict:
    d = cfg.d_model
    He, bs = _slstm_dims(cfg)
    return {
        "wx": ParamDef((d, 4, He, bs), ("embed", None, "shead", None)),
        "r": ParamDef((4, He, bs, bs), (None, "shead", None, None), scale=0.5),
        "b": ParamDef((4, He, bs), (None, "shead", None), init="zeros"),
        "wo": ParamDef((He, bs, d), ("shead", None, "embed")),
    }


def slstm_block(p, x, cfg, state: Optional[SLSTMState] = None):
    dt_ = x.dtype
    B, S, d = x.shape
    He, bs = _slstm_dims(cfg)
    zx = matmul_w(x, p["wx"]).float()                           # (B,S,4,He,bs)
    zx = shard(zx, "batch", None, None, "shead", None)
    R = p["r"].float()
    bias = p["b"].float()

    if state is None:
        z0 = torch.zeros((B, He, bs), dtype=torch.float32, device=x.device)
        c, n, h = z0, z0, z0
        m = torch.full((B, He, bs), -1e30, dtype=torch.float32, device=x.device)
    else:
        c, n, h, m = (s.float() for s in state)

    sh = ("batch", "shead", None)
    hseq, c, n, h, m = local_fn(
        _slstm_scan, (zx, R, bias, c, n, h, m),
        (("batch", None, None, "shead", None), (None, "shead", None, None),
         (None, "shead", None), sh, sh, sh, sh),
        (("batch", None, "shead", None), sh, sh, sh, sh))
    out = matmul_w(hseq.to(dt_), p["wo"], n_in=2)
    return shard(out, "batch", None, "act_embed"), SLSTMState(c, n, h, m)


def _slstm_scan(zx, R, bias, c, n, h, m):
    """The sLSTM recurrence over time → (h over time (B, S, He, bs), final
    c, n, h, m)."""
    hs = []
    for t in range(zx.shape[1]):
        rec = torch.einsum("bhu,ghuv->bghv", h, R)              # (B,4,He,bs)
        pre = zx[:, t] + rec + bias[None]
        it, ft, zt_, ot = pre[:, 0], pre[:, 1], pre[:, 2], pre[:, 3]
        logf = F.logsigmoid(ft)
        m_new = torch.maximum(logf + m, it)
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(logf + m - m_new)
        c = f_p * c + i_p * torch.tanh(zt_)
        n = f_p * n + i_p
        h = torch.sigmoid(ot) * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), c, n, h, m


def slstm_state_def(cfg, batch: int):
    He, bs = _slstm_dims(cfg)

    def s():
        return torch.empty((batch, He, bs), dtype=torch.float32, device="meta")
    return SLSTMState(s(), s(), s(), s())
