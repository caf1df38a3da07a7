"""Plain references of an index build.

For each row x of the benchmark's vectors and a codebook C: the primary
partition argmin_j ||x − c_j||²; the SOAR spill argmin over j ≠ primary of
||x − c_j||² + λ (⟨r̂, x⟩ − ⟨r̂, c_j⟩)², r̂ the unit residual to the primary
(Sun et al. 2023, Theorem 3.1); each assignment's PQ code, per subspace the
nearest of the 16 centres to the residual. `*_gap` functions judge a given
choice by how far its loss lies above the best; `*_choice` functions are
the reference's own choices, which the control puts in the program's place.

The codebooks' training: k-means++ seeding on a row sample, then full-batch
Lloyd sweeps until the mean distortion stops improving (`kmeans`), the
settings of a plain build (`CODEBOOK`, `PQ`). `distortion` and
`pq_distortion` price a codebook on every row.
"""
from __future__ import annotations

import torch

from annbench.reference.precision import operand, rowdot

BLOCK = 16_384
# plain Lloyd settings: sweeps at most, relative improvement that stops them,
# rows of the k-means++ seeding sample; the PQ's rows trained on (the coarse
# codebook trains on the configuration's `train_sample`)
CODEBOOK = {"iters": 15, "tol": 1e-5, "init_sample": 32_768}
PQ = {"iters": 8, "tol": 1e-5, "init_sample": 32_768, "sample": 32_768}


def _sqdist(xb, C, prec):
    d = torch.addmm((C * C).sum(1)[None, :], operand(xb, prec), operand(C, prec).T, alpha=-2.0)
    return d.add_((xb * xb).sum(1, keepdim=True))


def _soar_loss(xb, C, prim, lam, prec, d=None):
    """The SOAR loss of every partition for each row, given its primary
    (inf at the primary); `d` the rows' squared distances, consumed."""
    d = _sqdist(xb, C, prec) if d is None else d
    r = xb - C[prim]
    rhat = r / torch.linalg.vector_norm(r, dim=1, keepdim=True).clamp(min=1e-30)
    proj = torch.addmm(rowdot(rhat, xb, prec)[:, None], operand(rhat, prec),
                       operand(C, prec).T, alpha=-1.0)
    loss = d.add_(proj.square_().mul_(lam))
    return loss.scatter_(1, prim[:, None], float("inf"))


def assign_choice(X, C, prec: str = "f32") -> torch.Tensor:
    """The primary partition of every row → (n,) int64."""
    return torch.cat([_sqdist(X[i:i + BLOCK], C, prec).argmin(1)
                      for i in range(0, X.shape[0], BLOCK)])


def spill_choice(X, C, prim, lam: float, prec: str = "f32") -> torch.Tensor:
    """The SOAR spill of every row, given its primary → (n,) int64."""
    prim = prim.long()
    return torch.cat([_soar_loss(X[i:i + BLOCK], C, prim[i:i + BLOCK], lam, prec).argmin(1)
                      for i in range(0, X.shape[0], BLOCK)])


def _residual_dists(X, C, pq_centers, point, part, prec):
    """(b, m, 16) distances of each assignment's residual subvectors to the
    PQ centres; the direct differences at "f32", TF32 products at "tf32"."""
    m, j, s = pq_centers.shape
    r = (X[point] - C[part]).reshape(-1, m, s)
    if prec == "f32":
        diff = r[:, :, None, :] - pq_centers[None]
        return (diff * diff).sum(-1)
    cross = torch.einsum("bms,mjs->bmj", operand(r, prec), operand(pq_centers, prec))
    return ((r * r).sum(-1)[:, :, None] - 2.0 * cross
            + (pq_centers * pq_centers).sum(-1)[None])


def code_choice(X, C, pq_centers, point, part, prec: str = "f32") -> torch.Tensor:
    """Each assignment's PQ code → (n_assign, m) int64."""
    return torch.cat([_residual_dists(X, C, pq_centers, point[i:i + BLOCK],
                                      part[i:i + BLOCK], prec).argmin(-1)
                      for i in range(0, point.shape[0], BLOCK)])


def pair_gaps(X, C, pairs, lam: float):
    """(assign_gap, spill_gap) of each row's two partitions (n, 2), in
    either order; rows holding a -1 are skipped. Either of the two may be
    the row's primary (two partitions can lie equally near a row, to
    rounding): for each order, the primary's ||x − c||² above the least
    over all partitions, and the other's SOAR loss above the least over
    partitions other than the primary (inf where both are one partition);
    a row reads the order whose larger gap is smaller, and each gap is the
    widest over rows."""
    ag = sg = 0.0
    pairs = pairs.long()
    for i in range(0, X.shape[0], BLOCK):
        P = pairs[i:i + BLOCK]
        ok = (P >= 0).all(1)
        if not bool(ok.any()):
            continue
        xb, P = X[i:i + BLOCK][ok], P[ok]
        d = _sqdist(xb, C, "f32")
        a = d.gather(1, P) - d.min(1, keepdim=True).values       # (b, 2): each as primary
        s = torch.empty_like(a)
        for o in (0, 1):                                           # the last order consumes d
            loss = _soar_loss(xb, C, P[:, o], lam, "f32", d.clone() if o == 0 else d)
            s[:, o] = loss.gather(1, P[:, 1 - o:2 - o])[:, 0] - loss.min(1).values
        pick = torch.maximum(a, s).argmin(1, keepdim=True)
        ag = max(ag, float(a.gather(1, pick).max()))
        sg = max(sg, float(s.gather(1, pick).max()))
    return ag, sg


def code_gap(X, C, pq_centers, point, part, codes) -> float:
    """max over assignments and subspaces of the residual's distance to its
    code's centre above the nearest centre's."""
    g = 0.0
    codes = codes.long()
    for i in range(0, point.shape[0], BLOCK):
        d = _residual_dists(X, C, pq_centers, point[i:i + BLOCK], part[i:i + BLOCK], "f32")
        g = max(g, float((d.gather(2, codes[i:i + BLOCK, :, None])[..., 0]
                          - d.min(2).values).max()))
    return g


def distortion(X, C) -> float:
    """Mean over rows of min_j ||x − c_j||² (float64 sum)."""
    s = 0.0
    for i in range(0, X.shape[0], BLOCK):
        s += float(_sqdist(X[i:i + BLOCK], C, "f32").min(1).values.double().sum())
    return s / X.shape[0]


def pq_distortion(X, C, pq_centers, point, part) -> float:
    """Mean over assignments of the residual's squared distance to its
    nearest PQ reconstruction (the sum over subspaces of the least)."""
    s = 0.0
    for i in range(0, point.shape[0], BLOCK):
        d = _residual_dists(X, C, pq_centers, point[i:i + BLOCK], part[i:i + BLOCK], "f32")
        s += float(d.min(2).values.double().sum())
    return s / point.shape[0]


def _nearest(X, C, prec):
    """X (B, n, s), C (B, c, s) → (nearest (B, n) int64, mean least distance)."""
    idx, tot = [], 0.0
    for i in range(0, X.shape[1], BLOCK):
        xb = X[:, i:i + BLOCK]
        d = torch.baddbmm((C * C).sum(-1)[:, None, :], operand(xb, prec),
                          operand(C, prec).transpose(1, 2), alpha=-2.0)
        d.add_((xb * xb).sum(-1, keepdim=True))
        v, j = d.min(-1)
        idx.append(j)
        tot += float(v.double().sum())
    return torch.cat(idx, 1), tot / (X.shape[0] * X.shape[1])


def kmeans(gen: torch.Generator, X, c: int, iters: int, tol: float, init_sample: int,
           prec: str = "f32"):
    """B independent k-means problems X (B, n, s) → centroids (B, c, s).

    k-means++ seeding (exact D² draws) on `init_sample` rows of each, then
    Lloyd sweeps over all n rows, a centroid with no row keeping its place,
    until the mean distortion over the B problems improves by less than
    `tol` of itself or `iters` sweeps have run. Products at `prec`."""
    B, n, s = X.shape
    dev = X.device
    rows = torch.arange(B, device=dev)
    Xi = X
    if n > init_sample:
        Xi = X[:, torch.randperm(n, generator=gen)[:init_sample].to(dev)]
    ni = Xi.shape[1]
    u = torch.rand((c, B), generator=gen, dtype=torch.float64).to(dev)
    C = torch.empty((B, c, s), dtype=X.dtype, device=dev)
    best = torch.full((B, ni), float("inf"), dtype=torch.float64, device=dev)
    nxt = Xi[rows, (u[0] * ni).long().clamp(max=ni - 1)]
    for j in range(c):
        C[:, j] = nxt
        best = torch.minimum(best, ((Xi - nxt[:, None]) ** 2).sum(-1).double())
        if j + 1 < c:
            cdf = best.cumsum(1)
            k = torch.searchsorted(cdf, (u[j + 1] * cdf[:, -1])[:, None])[:, 0]
            nxt = Xi[rows, k.clamp(max=ni - 1)]
    prev = float("inf")
    for _ in range(iters):
        a, dist = _nearest(X, C, prec)
        sums = torch.zeros_like(C).scatter_add_(1, a[..., None].expand(-1, -1, s), X)
        cnt = torch.zeros((B, c), dtype=X.dtype, device=dev).scatter_add_(
            1, a, torch.ones_like(a, dtype=X.dtype))
        C = torch.where(cnt[..., None] > 0, sums / cnt.clamp(min=1.0)[..., None], C)
        if prev - dist < tol * abs(prev):
            break
        prev = dist
    return C


def _gen(seed: int, salt: int) -> torch.Generator:
    return torch.Generator().manual_seed((int(seed) * 2 + salt) & ((1 << 63) - 1))


def train_codebook(seed: int, X, c: int, sample: int, prec: str = "f32"):
    """The reference's coarse codebook: k-means at `CODEBOOK`'s settings on
    `sample` rows of X drawn from the seed → (c, d)."""
    g = _gen(seed, 0)
    Xt = X[torch.randperm(X.shape[0], generator=g)[:sample].to(X.device)] \
        if X.shape[0] > sample else X
    return kmeans(g, Xt[None], c, CODEBOOK["iters"], CODEBOOK["tol"],
                  CODEBOOK["init_sample"], prec)[0]


def train_pq(seed: int, X, C, point, part, m: int, prec: str = "f32"):
    """The reference's PQ codebook (m, 16, d / m): k-means of 16 centres in
    each subspace at `PQ`'s settings, on a sample drawn from the seed of
    the assignments' residuals x − c_part."""
    g = _gen(seed, 1)
    sel = torch.randperm(point.shape[0], generator=g)[:PQ["sample"]].to(point.device)
    R = X[point[sel]] - C[part[sel]]
    Rm = R.reshape(R.shape[0], m, -1).permute(1, 0, 2).contiguous()
    return kmeans(g, Rm, 16, PQ["iters"], PQ["tol"], PQ["init_sample"], prec)
