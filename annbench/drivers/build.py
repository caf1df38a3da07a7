"""Index builds back to back.

Set-up makes the configuration's vectors from the seed and runs one build
(the kernels' shapes warmed). The window calls `build_ivf_sharded` with the
configuration's settings and the run's seed, back to back, until `seconds`
have passed; `build_vps` is every vector of every build over the whole
time. After the window the last build's index answers the queries once for
`recall10`.

Correctness, on the last build's index: its codebook and its PQ codebook
against the reference's own training on the same vectors (`reference/
build.py`: the k-means distortion over every row, and the PQ distortion of
every assignment's residual, each over the reference's), and every row's
two partitions and every PQ code given those codebooks (`compare.index`).
The control is the reference's whole build at TF32 in the program's place.
"""
from __future__ import annotations

import time

import torch

from annbench import compare, data, program, tracing
from annbench.reference import build as rb
from annbench.reference import search as ref


def setup(ctx):
    v = data.make(ctx.cfg["data"], ctx.seed, ctx.device)
    tracing.note("vectors made")
    program.build_index(ctx.cfg, v.X, ctx.seed, ctx.device, timings={})
    tracing.note("build warmed")
    return {"v": v}


def _sync(ctx):
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)


def _loop(ctx, seconds: float) -> dict:
    X = ctx.state["v"].X
    builds, timings, index = 0, [], None
    t0 = time.perf_counter()
    while True:
        tm: dict = {}
        index = None                          # the last build's memory, released
        with tracing.span("build_ivf_sharded"):
            index = program.build_index(ctx.cfg, X, ctx.seed, ctx.device, timings=tm)
            _sync(ctx)
        builds += 1
        timings.append(tm)
        if time.perf_counter() - t0 >= seconds:
            break
    tot = sorted(sum(t.values()) for t in timings)
    tracing.note(f"{builds} builds, phase seconds a build: min {tot[0]:.4f} "
                 f"median {tot[len(tot) // 2]:.4f} max {tot[-1]:.4f}")
    return {"builds": builds, "elapsed_s": time.perf_counter() - t0, "timings": timings,
            "index": index, "attempted": builds, "failed": 0}


def window(ctx, seconds: float) -> dict:
    return _loop(ctx, seconds)


def traced(ctx, seconds: float) -> dict:
    return _loop(ctx, seconds)


def end_to_end(ctx) -> dict:
    rec, v = ctx.rec, ctx.state["v"]
    k = ctx.cfg["search"]["k"]
    _, SearchParams, _, _ = program.api()
    eng = program.engine_over(ctx.cfg, rec["index"])
    ids = torch.from_numpy(eng.search_request(v.Q.cpu().numpy(), SearchParams(k=k)).ids)
    _, true = ref.exact_topk(v.Q, v.X, k)
    hits = int((true[:, :, None] == ids.to(true.device).long()[:, None, :]).any(2).sum())
    return {"build_vps": rec["builds"] * v.X.shape[0] / rec["elapsed_s"],
            "recall10": hits / (v.Q.shape[0] * k)}


def _csr_pairs(index):
    """(point, partition) of every CSR slot."""
    sizes = torch.diff(index.starts)
    part = torch.repeat_interleave(torch.arange(sizes.shape[0], device=sizes.device), sizes)
    return index.point_ids.long(), part


def numbers(ctx, control: bool = False) -> dict:
    """The last build's codebooks, assignments and codes (or, for the
    control, the reference's own build at TF32) against the float32
    references."""
    X, seed = ctx.state["v"].X, ctx.seed
    ix = ctx.cfg["index"]
    lam, c, m = float(ix["lam"]), int(ix["n_partitions"]), int(ix["pq_subspaces"])
    C_ref = rb.train_codebook(seed, X, c, int(ix["train_sample"]))
    if control:
        C = rb.train_codebook(seed, X, c, int(ix["train_sample"]), "tf32")
        prim = rb.assign_choice(X, C, "tf32")
        point = torch.arange(X.shape[0], device=X.device).repeat_interleave(2)
        part = torch.stack([prim, rb.spill_choice(X, C, prim, lam, "tf32")], 1).reshape(-1)
        centers = rb.train_pq(seed, X, C, point, part, m, "tf32")
        codes = rb.code_choice(X, C, centers, point, part, "tf32")
    else:
        index = ctx.rec["index"]
        C, centers = index.centroids, index.pq.centers
        point, part = _csr_pairs(index)
        codes = index.codes
    out = compare.index(X, C, centers, point, part, codes, lam, 1 + int(ix["n_spills"]))
    pq_ref = rb.train_pq(seed, X, C, point, part, m)
    out["codebook_excess"] = rb.distortion(X, C) / rb.distortion(X, C_ref) - 1.0
    out["pq_excess"] = (rb.pq_distortion(X, C, centers, point, part)
                        / rb.pq_distortion(X, C, pq_ref, point, part) - 1.0)
    return out
