"""Plain PyTorch versions of every CUDA kernel of the port.

Counterparts of `repro/kernels/ref.py` plus the Lloyd sweep, the
two-level route, the probe-id window scorer and its selecting form,
k-means++ seeding (the pick loop and its integer-CDF draw) and the int8
rerank: each computes the same
function as its kernel, in tensor ops, on any device. The kernel
wrappers take these for CPU tensors; the tests hold them against the JAX
package, and `chip_smoke.py` holds the kernels against them on the card.
Rows are processed in chunks so that no intermediate outgrows
(chunk x c) or (rows x cand x m) elements.
"""
from __future__ import annotations

import torch

from repro_torch.utils import pairwise_neg_sqdist_argmin, topk_first

_ROW_CHUNK = 16_384
_GATHER_ELEMS = 1 << 25


def pq_score_ref(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """luts (nq, m, 16) f32, codes (n, m) int → scores (nq, n).

    score[q, i] = Σ_m luts[q, m, codes[i, m]]: every query scores every
    row, as a flat LUT gather over row chunks of codes.
    """
    nq, m, k = luts.shape
    n = codes.shape[0]
    lutflat = luts.reshape(nq, m * k)
    offs = torch.arange(m, device=codes.device, dtype=torch.int64) * k
    out = torch.empty((nq, n), dtype=luts.dtype, device=luts.device)
    step = max(1, _GATHER_ELEMS // max(1, nq * m))
    for i0 in range(0, n, step):
        idx = codes[i0:i0 + step].to(torch.int64) + offs          # (rows, m)
        out[:, i0:i0 + step] = lutflat[:, idx].sum(-1)
    return out


def pq_score_window_ref(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """luts (nq, m, 16) f32, codes (nq, cand, m) int → scores (nq, cand).

    score[q, i] = Σ_m luts[q, m, codes[q, i, m]], as a flat per-query LUT
    gather (`repro/core/search.py::window_pq_scores`, non-TPU branch).
    """
    nq, cand, m = codes.shape
    k = luts.shape[-1]
    lutflat = luts.reshape(nq, m * k)
    offs = torch.arange(m, device=codes.device, dtype=torch.int64) * k
    out = torch.empty((nq, cand), dtype=luts.dtype, device=luts.device)
    step = max(1, _GATHER_ELEMS // max(1, cand * m))
    for q0 in range(0, nq, step):
        idx = codes[q0:q0 + step].to(torch.int64) + offs
        g = torch.gather(lutflat[q0:q0 + step], 1,
                         idx.reshape(idx.shape[0], cand * m))
        out[q0:q0 + step] = g.reshape(-1, cand, m).sum(-1)
    return out


def pq_score_probes_ref(luts: torch.Tensor, part_codes: torch.Tensor,
                        extent: torch.Tensor, parts: torch.Tensor,
                        psc: torch.Tensor) -> torch.Tensor:
    """luts (nq, m, 16), part_codes (c, pmax, m), extent (c,), parts (nq, t),
    psc (nq, t) → (nq, t·pmax).

    The search's window scoring as the JAX package runs it: gather each
    query's (t·pmax) window of codes, score it (`pq_score_window_ref`), add
    the coarse term psc per probe and set the slots past each partition's
    extent (i ≥ extent[parts[q, j]]) to −inf.
    """
    nq, t = parts.shape
    pmax = part_codes.shape[1]
    p = parts.to(torch.int64)
    approx = pq_score_window_ref(luts, part_codes[p].reshape(nq, t * pmax, -1))
    approx = approx + torch.repeat_interleave(psc, pmax, dim=-1)
    valid = torch.arange(pmax, device=parts.device) < extent[p][..., None]
    return torch.where(valid.reshape(nq, t * pmax), approx, float("-inf"))


def pq_score_probes_select_ref(luts: torch.Tensor, part_codes: torch.Tensor,
                               extent: torch.Tensor, parts: torch.Tensor,
                               psc: torch.Tensor, part_ids: torch.Tensor, keep: int,
                               filter=None):
    """As `pq_score_probes_ref`, plus part_ids (c, pmax), keep and an
    optional (n,) uint8 filter → (ids (nq, keep) int32, scores (nq, keep)).

    Each query's top `keep` candidates of its window by (score
    descending, slot ascending): `topk_first` over the window with every
    slot that is no candidate at −inf. A candidate has a finite score, an
    id ≥ 0 and, given a filter, an id it passes. Ranks past the
    candidates hold (−1, −inf).
    """
    nq = parts.shape[0]
    scores = pq_score_probes_ref(luts, part_codes, extent, parts, psc)
    ids = part_ids[parts.to(torch.int64)].reshape(nq, -1)
    ok = (ids >= 0) & (scores > float("-inf"))
    if filter is not None:
        ok &= filter[ids.clamp(min=0).to(torch.int64)] > 0
    v, pos = topk_first(scores.masked_fill_(~ok, float("-inf")), min(keep, ids.shape[1]))
    ids = torch.where(v > float("-inf"), torch.gather(ids, 1, pos), -1).to(torch.int32)
    short = keep - v.shape[1]
    return (torch.nn.functional.pad(ids, (0, short), value=-1),
            torch.nn.functional.pad(v, (0, short), value=float("-inf")))


def int8_scores_ref(Q: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                    ids: torch.Tensor) -> torch.Tensor:
    """Q (nq, d) f32, codes (n, d) int8, scale (n,) f32, ids (nq, w) int
    in [0, n) → (nq, w) f32: ⟨Q[q], codes[id]⟩ summed in f32, times
    scale[id]. The rerank of the int8 rows on the CPU, and on any device
    the exact-window path's scores."""
    rows = ids.to(torch.int64)
    return torch.einsum("qwd,qd->qw", codes[rows].to(torch.float32), Q) * scale[rows]


def int8_rerank_ref(Q: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                    ids: torch.Tensor, approx: torch.Tensor, k: int):
    """`csrc/int8_rerank.cu`'s function: ids, approx (nq, B) → (ids (nq,
    k) int32, scores (nq, k) f32). A slot whose approx is finite scores
    `int8_scores_ref`, any other −inf; each query's top k slots by
    `topk_first` with their ids, (−1, −inf) past B."""
    ok = torch.isfinite(approx)
    s = torch.where(ok, int8_scores_ref(Q, codes, scale, torch.where(ok, ids, 0)),
                    float("-inf"))
    v, pos = topk_first(s, min(k, s.shape[1]))
    out = torch.gather(ids, 1, pos).to(torch.int32)
    short = k - v.shape[1]
    return (torch.nn.functional.pad(out, (0, short), value=-1),
            torch.nn.functional.pad(v, (0, short), value=float("-inf")))


def vq_assign_ref(X: torch.Tensor, C: torch.Tensor):
    """Nearest centroid by squared L2 → (idx (n,) int32, sqdist (n,)).

    argmin_j ||c_j||² − 2⟨x, c_j⟩ (first index on ties); the returned
    distance adds ||x||² back, as `vq_assign_pallas` does.
    """
    return pairwise_neg_sqdist_argmin(X, C, chunk=_ROW_CHUNK)


def soar_assign_ref(X: torch.Tensor, rhat: torch.Tensor, primary: torch.Tensor,
                    C: torch.Tensor, lam: float):
    """SOAR spilled assignment (Theorem 3.1 loss), primary excluded.

    loss_ij = ||c_j||² − 2⟨x_i,c_j⟩ + lam·(⟨r̂_i,x_i⟩ − ⟨r̂_i,c_j⟩)²
    Returns (idx (n,) int32, loss at idx (n,) incl. the ||x||² term).
    """
    cn = (C * C).sum(-1)
    idx = torch.empty(X.shape[0], dtype=torch.int32, device=X.device)
    val = torch.empty(X.shape[0], dtype=X.dtype, device=X.device)
    for i0 in range(0, X.shape[0], _ROW_CHUNK):
        xb, rb = X[i0:i0 + _ROW_CHUNK], rhat[i0:i0 + _ROW_CHUNK]
        pb = primary[i0:i0 + _ROW_CHUNK].to(torch.int64)
        rx = (rb * xb).sum(-1)
        loss = cn[None, :] - 2.0 * (xb @ C.T) + lam * (rx[:, None] - rb @ C.T) ** 2
        loss.scatter_(1, pb[:, None], float("inf"))
        v, j = loss.min(-1)
        idx[i0:i0 + xb.shape[0]] = j.to(torch.int32)
        val[i0:i0 + xb.shape[0]] = v + (xb * xb).sum(-1)
    return idx, val


def lloyd_sweep_ref(X: torch.Tensor, C: torch.Tensor, chunk: int = 8192):
    """One Lloyd iteration → (new_C (c, d), counts (c,) f32, mean distortion).

    Mirrors `repro/kernels/lloyd.py::lloyd_sweep`: per row-chunk argmin of
    ||c||² − 2⟨x,c⟩, per-centroid sums/counts accumulated chunk by chunk.
    Empty clusters keep their old centroid.
    """
    n = X.shape[0]
    c = C.shape[0]
    sums = torch.zeros_like(C)
    counts = torch.zeros(c, dtype=X.dtype, device=X.device)
    loss = torch.zeros((), dtype=X.dtype, device=X.device)
    for i0 in range(0, n, chunk):
        xb = X[i0:i0 + chunk]
        idx, mind = vq_assign_ref(xb, C)
        idx = idx.to(torch.int64)
        sums.index_add_(0, idx, xb)
        counts.index_add_(0, idx, torch.ones_like(mind))
        loss = loss + mind.sum()
    new_C = torch.where(counts[:, None] > 0,
                        sums / counts.clamp(min=1.0)[:, None], C)
    return new_C, counts, loss / n


def tree_route_ref(Q: torch.Tensor, SC: torch.Tensor, CC: torch.Tensor,
                   CH: torch.Tensor, t_route: int):
    """Two-level route → (scores (nq, t_route·cmax), ids (nq, t_route·cmax)).

    One (nq, S) product, the top-t_route supers in descending order with
    the lowest index on ties (`jax.lax.top_k`'s order, by a stable sort),
    then per round the chosen super's children's ⟨q, c⟩, with -inf where
    the children table holds -1 (its id stays -1). Mirrors
    `repro/kernels/tree_route.py::tree_route_ref`.
    """
    ss = Q @ SC.T                                               # (nq, S)
    sup = torch.sort(ss, dim=-1, descending=True, stable=True).indices[:, :t_route]
    scores, ids = [], []
    for r in range(t_route):
        s_r = sup[:, r]
        cid = CH[s_r]                                           # (nq, cmax)
        sc = torch.einsum("qcd,qd->qc", CC[s_r], Q)
        scores.append(torch.where(cid >= 0, sc, float("-inf")))
        ids.append(cid)
    return torch.cat(scores, -1), torch.cat(ids, -1).to(torch.int32)


def d2_scale(n: int) -> float:
    """The integer CDF's scale for rows of n weights: 2**40, less from
    n = 2**22 on, so that n weights of at most the scale sum below 2**62."""
    return float(2 ** min(40, 62 - n.bit_length()))


def d2_draw(weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draws: for each row of weights (m, n) ≥ 0, an index i
    with probability ∝ weights[i], from one uniform u (m,) in [0, 1).

    The CDF is an integer one: each weight scaled to `d2_scale(n)` of its
    row's largest and truncated, then an int64 cumsum. That sum is exact,
    so a seed draws the same index on every run (`torch.cumsum` of floats
    on CUDA does not promise that: its association follows the timing of
    its blocks, so two builds of one shard could pick other seeds), and a
    zero weight is never drawn. A row of zeros draws index 0."""
    top = weights.amax(-1, keepdim=True)
    scale = d2_scale(weights.shape[-1])
    cdf = torch.cumsum((weights * (scale / torch.where(top > 0, top, 1.0))).to(torch.int64), -1)
    total = cdf[:, -1:]
    t = (u[:, None] * total.to(u.dtype)).to(torch.int64)
    return torch.searchsorted(cdf, torch.minimum(t, total - 1) + 1)[:, 0]


def kmeans_pp_ref(X: torch.Tensor, first: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """k-means++ seeding of m problems X (m, n, d) → centres (m, c, d), c =
    len(u) + 1: row first[p] (m,) first, then pick i from the uniforms
    u[i − 1] (c − 1, m) by an exact D² draw (`d2_draw`). Distances update
    through ||x||² − 2⟨x, c_new⟩ + ||c_new||², one GEMV a pick."""
    m, n, d = X.shape
    c = u.shape[0] + 1
    dev = X.device
    xn = (X * X).sum(-1)                                      # (m, n)
    rows = torch.arange(m, device=dev)
    cents = torch.zeros((m, c, d), dtype=X.dtype, device=dev)

    def dist_to(v):                                           # v (m, d)
        dv = xn - 2.0 * torch.bmm(X, v[:, :, None])[..., 0] + (v * v).sum(-1)[:, None]
        return dv.clamp(min=0.0)

    nxt = X[rows, first]
    cents[:, 0] = nxt
    min_d = dist_to(nxt)
    for i in range(1, c):
        idx = d2_draw(min_d, u[i - 1])
        nxt = X[rows, idx]
        cents[:, i] = nxt
        min_d = torch.minimum(min_d, dist_to(nxt))
    return cents
