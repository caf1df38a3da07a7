#!/usr/bin/env python3
"""Drive the PyTorch port of SOAR (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--parent DIR]

Phases (any failure exits nonzero; nothing is caught). Each path below is
driven with every kernel's launch counter set to 0 just before and read
just after, and fails if one of its kernels was never launched:
  1. device: nvidia-smi's name and power limit, torch's device name;
  2. build: nvcc builds the CUDA kernels from src/repro_torch/csrc;
  3. main path at GloVe-100-angular's shape (ann-benchmarks
     glove-100-angular: 1,183,514 x 100, 10k queries; here n=1,000,000,
     d=100, nq=10,000 from make_manifold(seed)) with ScaNN's published
     ann-benchmarks config for that set (num_leaves=2000, dims_per_block=2,
     so 50 PQ subspaces): build_ivf_sharded (SOAR lam=1, f32 rerank, and a
     tree router at the JAX package's defaults: 45 supers, t_route 6) ->
     pack_ivf -> search_jit_batched through the flat router (top_t=40,
     final_k=10, rerank_budget=256, bq=128), cold then warm (QPS from the
     first warm run, and the median of five warm runs beside it). Checks
     recall@10 >= 0.85 against exact search, one window-scoring launch per
     tile, ids agreeing on >= 99% of slots with the same search through
     the plain probe scorer, and the index's whole (n x 2) assignment
     matrix agreeing on >= 99.9% of rows per column with assign_shards run
     through the plain vq and soar versions; prints the spill phase run
     again warm (host clock) and one shard's assign_fused (CUDA events),
     and one warm tile's stage times (route, ids
     gather, window scoring, dedup, rerank) and the warm search's own peak
     memory (kernels: Lloyd, vq_assign, soar_assign, pq_score_probes);
  4. tree-routed search of the same queries through the index's tree
     router, warm: recall@10 >= 0.85, one tree_route launch per tile, ids
     agreeing on >= 99% of slots with the same search through the plain
     route (kernels: tree_route, pq_score_probes);
  5. filtered tree-routed search with seeded bitmaps keeping 1% and 0.1%
     of the points, each with and without the escalated second pass:
     every returned id passes the filter, and recall@10 against exact
     filtered search is no lower with escalation;
  6. dense PQ scan of 128 queries over every code row of the index through
     kernels.ops.pq_score, plus the coarse term, best row per point, top-10
     (kernel: pq_score): ids agree on >= 99% of slots with the same scan
     through the plain scorer;
  7. tombstones on the card: the main packed table with 20% of each
     partition's live slots set to -1 in place (the extent kept, sizes the
     live count), searched flat: no row returns a -1 while its window holds
     2 * final_k live slots, and ids agree on >= 99% of slots with the same
     search through the plain probe scorer (kernel: pq_score_probes);
  8. k-means modes on the first 131,072 rows, c = 2,000: train_kmeans with
     init="parallel", batch_size=16,384, spherical=True, the full-batch
     k-means++ baseline, and the baseline with the Lloyd sweep's plain
     version ("plain Lloyd"); distortion and seconds of each, and the
     parallel and mini-batch distortion no more than 5% above the
     baseline's (kernel: Lloyd);
  9. variant A, the sharded build as the paper and ScaNN serve GloVe:
     build_ivf_sharded(spill_mode="soar", n_spills=2, lam=1,
     anisotropic_T=0.2 (ScaNN's anisotropic_quantization_threshold in its
     ann-benchmarks glove-100-angular config), rerank="int8",
     pq_subspaces=50), then the flat search cold and warm: build phases,
     memory_bytes("int8"), recall@10 >= 0.85 beside the main path's, QPS,
     peak memory; the three columns of every row distinct, each column
     agreeing on >= 99.9% of rows with assign_shards through the plain vq
     and soar versions, and the int8 codes and scales of the first 65,536
     rows equal to the CPU quantization's (kernels: Lloyd, vq_assign,
     soar_assign, pq_score_probes);
 10. variant B, the monolithic build on anisotropic primaries:
     build_ivf(spill_mode="soar", n_spills=1, anisotropic_T=0.2,
     rerank="f32", pq_subspaces=50) over all 1,000,000 rows, then the flat
     search: build phases, recall@10 >= 0.85, QPS, peak memory, and the
     spill column agreeing on >= 99.9% of rows with soar_assign_ref on the
     card (kernels: Lloyd, soar_assign, pq_score_probes). Phases 9-10
     count the calls of the build's plain-torch work (the spill columns
     after the first, anisotropic_assign, the anisotropic update's normal
     equations and solve, int8_quantize), which no Pallas kernel computes
     in the JAX package;
 11. serving: the main index of phase 3 wrapped by MutableIVF.from_index
     behind AnnEngine(top_t=40, rerank_budget=256, bq=128); the 10,000
     queries cold and warm through search_request (ids equal to phase 4's
     tree search on >= 99.9% of slots: the same index at the capacity
     width); ten rounds each hard-removing 1,000 random live ids,
     re-adding their vectors (new ids), delta-packing and searching one
     128-query tile, each step's host-clock ms after a synchronise, and
     the delta pack held bit for bit against a full repack
     (invalidate_snapshots) in part_ids, part_codes, sizes, extent and the
     live rerank rows; 10,000 soft removals searched through the standing
     filter, then harden_soft_deletes and compact (ms). Checks: no removed
     or soft-removed id ever returned; the last round's re-added vectors
     find their new id in their own top 10 on >= 90% of rows (top 1
     printed beside it; under MIPS a larger-norm point may outrank a
     point's own); rebuild_reference -> pack_ivf -> the same search gives
     the engine's ids under the id map on >= 99.9% of slots (identity
     expected: the assignment kernels and the s = 2 PQ encode are
     row-independent); search_numpy over to_ivf_index() for 1,000 queries
     (top_t 40, rerank_budget 256) has recall@10 >= 0.85 against exact
     search of the live rows, with its QPS and agreement with the engine.
     Prints the phase's peak memory (kernels: vq_assign, soar_assign,
     tree_route, pq_score_probes);
 12. paper metrics at the main path's shape: the exact top 100 of the
     10,000 queries, then KMR curves (kmr_curve) of the main index (SOAR,
     lam=1) and of build_ivf_sharded(spill_mode="none") and ("naive") on
     the main index's codebook and PQ (one rank space). Checks: each curve
     non-decreasing, ending at recall 1.0 and at n_assignments points;
     naive's and SOAR's recall at every t >= none's; rank_statistics of
     the first 1,000 queries on the card equal to the same call on CPU
     copies on >= 99.9% of (query, neighbour) entries. Prints
     points_to_recall at 0.8 / 0.9 / 0.95 / 0.99 for each index, the
     score-error and angle correlations of naive and SOAR (pair_stats;
     the paper's Figs 4, 7, 9), the phase's seconds and peak memory; the
     two extra builds are freed after it (kernels: vq_assign, soar_assign);
 13. durability, from phase 11's engine after its rounds: AnnEngine.save
     into a temporary directory (bytes, seconds, GB/s); AnnEngine.open on
     the card equal to the saved engine bit for bit (part_ids,
     part_codes, sizes, rerank, assignments, alive, centroids, PQ, the
     counters, wal_seq, the router's tables) and its ids equal on every
     slot of the 10,000 queries; then a log attached (fsync "always"),
     three rounds of 1,000 hard removals and re-adds, 1,000 soft removals
     and harden_soft_deletes; a second engine opened from the snapshot
     and the log equal to the live one bit for bit, with equal ids on
     every slot, its replayed adds launching vq_assign and soar_assign;
     one byte of arrays.bin flipped, after which open raises
     CorruptSnapshotError. Prints replay seconds and the log's bytes
     (kernels: vq_assign, soar_assign, tree_route, pq_score_probes);
 14. each kernel against its plain PyTorch version on the paths' own
     inputs, with its time (CUDA events), the plain version's time and the
     least time the card could take: the larger of bytes / 3.35 TB/s and
     the operations' time, where f32 products (x·cᵀ) count at the TF32
     tensor-core peak three times over (3xTF32, f32 accuracy: 495 TFLOP/s)
     and other f32 work at 67 TFLOP/s (the H100 SXM's published peaks);
     the assignment kernels also print the f32 SIMT figure beside it, the
     vq and soar records the time cuBLAS takes for their products alone
     (product_ms: torch.mm of the shard by the codebook, TF32 off, once
     for vq and twice for soar; a yardstick the port never calls), and
     the Lloyd record gives its launches by shape and the device times of
     its assignment and grouping phases apart (each queued behind a longer
     kernel, so host overhead between launches is not counted); the tree
     route and the dense scorer are timed the same way (device time
     alone), the route also at a second shape that stands for c = 32,768
     at the router's defaults (seeded tables, S = 181, t_route = 23,
     cmax = 256), with its wrapper's and the whole router call's host
     microseconds per call (host clock over many calls, no synchronisation
     between them); with --parent DIR (a checkout of the parent commit,
     unpacked beside this one) the parent's route and dense kernels are
     built from DIR and timed on the same inputs in the same way
     ("parent_ms", null without it); the vq and soar records also give
     the kernel at the online inserts' batch (1,000 rows, "online"); the
     dense record also gives its
     lookup floor: n * nq * m LUT lookups at 32 four-byte words a clock an
     SM (the 128 bytes an SM's shared memory delivers), at the card's SM
     count and its maximum SM clock (nvidia-smi); then the plain-torch work
     of phases 9-10 timed the same way at the build's shapes, each beside
     its calls and its bound (bytes / 3.35 TB/s against f32 operations /
     67 TFLOP/s), on a "plain work" line. "launches" of a kernel sum every
     driven path above but the filtered one;
 15. the {"kernels": [...]} line, then the device line, last.

It imports nothing of JAX and nothing of the JAX package (src/repro).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter
from contextlib import ExitStack, contextmanager
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N, D, NQ = 1_000_000, 100, 10_000
C, M = 2000, 50
TOP_T, FINAL_K, BUDGET, BQ = 40, 10, 256, 128
TRAIN_SAMPLE, SHARD = 131_072, 65_536
SELECTIVITIES = (0.01, 0.001)      # filtered phase: shares of points kept
ROUNDS, CHURN, SOFT = 10, 1000, 10_000  # serving phase: mutation rounds, ids a round, soft removals
HOST_NQ = 1000                     # serving phase: queries of the host engine
KMR_K, KMR_TARGETS = 100, (0.8, 0.9, 0.95, 0.99)  # paper metrics: neighbours, recall targets
RANK_NQ = 1000                     # paper metrics: queries whose ranks are checked on the CPU
WAL_ROUNDS = 3                     # durability: logged rounds of CHURN removals and re-adds
ANISO_T = 0.2                      # ScaNN's glove-100-angular anisotropic threshold
DENSE_ROWS = 1_000_000             # code rows of the dense kernel check
PEAK_BYTES_S, PEAK_F32_S, PEAK_TF32_S = 3.35e12, 67e12, 495e12
SMEM_WORDS_CLK = 32    # 4-byte words an SM's shared memory delivers a clock (128 B)
DEVICE = "cuda"


def sync():
    torch.cuda.synchronize()


def time_ms(fn, reps: int = 10) -> float:
    """Mean device milliseconds of fn() over reps launches, after a warm-up."""
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, busy, reps: int = 10) -> float:
    """Mean device milliseconds of fn()'s launches alone: each round first
    queues busy() (a longer kernel), so the host has queued all of fn's
    launches before the device reaches them and host overhead between
    them does not count."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for r in range(reps + 1):
        busy()
        start.record()
        fn()
        end.record()
        end.synchronize()
        if r:                                   # the first round warms up
            total += start.elapsed_time(end)
    return total / reps


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per call of fn() over `calls` calls with no
    synchronisation between them: the wrapper's own cost while the device
    works behind it."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    sync()
    return t / calls * 1e6


def parent_build(parent: Path):
    """The kernel builder of the checkout at `parent` (loaded from its
    file, so it builds that checkout's sources into its own build/)."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", parent / "src" / "repro_torch" / "kernels" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.library()
    return mod


def tree_tables(seed: int, S: int, cmax: int, d: int, device):
    """Seeded router tables with ragged children (-1 padded, zero rows),
    as `train_tree_router` lays them out."""
    g = torch.Generator().manual_seed(seed)
    SC = torch.randn((S, d), generator=g)
    CC = torch.randn((S, cmax, d), generator=g)
    pad = torch.rand((S, cmax), generator=g) < 0.25
    pad[:, 0] = False
    CH = torch.where(pad, -1, torch.arange(S * cmax).reshape(S, cmax)).to(torch.int32)
    CC[pad] = 0.0
    return SC.to(device), CC.to(device), CH.to(device)


def bound(nbytes: float, ops: float, mm_ops: float = 0.0):
    """(least ms, what bounds it): bytes at the memory rate against `ops`
    f32 operations at the SIMT rate plus `mm_ops` f32 product operations
    as 3xTF32 on the tensor cores."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = (ops / PEAK_F32_S + 3 * mm_ops / PEAK_TF32_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextmanager
def plain_version(module, name: str, plain):
    """Run with `module.name` (a kernel's wrapper) replaced by its plain
    version."""
    saved = getattr(module, name)
    setattr(module, name, plain)
    try:
        yield
    finally:
        setattr(module, name, saved)


def drive(wrappers: dict, needs, fn):
    """Run one path with every launch counter at 0 → (fn's result, the
    counts after it); fails if a kernel in `needs` was never launched."""
    for w in wrappers.values():
        w.launches = 0
        if hasattr(w, "shapes"):
            w.shapes.clear()
    out = fn()
    sync()
    counts = {k: w.launches for k, w in wrappers.items()}
    assert all(counts[k] > 0 for k in needs), f"a kernel never ran: {counts}"
    return out, counts


def timed(fn):
    """(fn(), host seconds to the end of its device work)."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def tile_stages(search, packed, Q, router, reps: int = 10) -> dict:
    """Milliseconds of each stage of one warm unfiltered search tile (the
    stages of search._search_pass) between CUDA events on the device's
    timeline, so time the device waits on the host inside a stage counts."""
    from repro_torch.quant.pq import pq_lut
    from repro_torch.utils import topk_first
    names = ("route", "ids_gather", "window_scoring", "mask", "dedup", "rerank")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
    total = dict.fromkeys(names, 0.0)
    for r in range(reps + 1):
        ev[0].record()
        psc, parts = router.route(Q, TOP_T)
        ev[1].record()
        ids = packed.part_ids[parts].reshape(Q.shape[0], -1)
        ev[2].record()
        approx = search.pq_score_probes(pq_lut(packed.pq, Q), packed.part_codes,
                                        packed.extent, parts, psc)
        ev[3].record()
        approx = approx.masked_fill_(ids < 0, float("-inf"))
        ev[4].record()
        bi, bv = search.dedup_topk_window(ids, approx, BUDGET, 2)
        ev[5].record()
        exact = torch.einsum("qbd,qd->qb", packed.rerank[bi.clamp(min=0).long()], Q)
        exact = torch.where(torch.isfinite(bv), exact, float("-inf"))
        topk_first(exact, FINAL_K)
        ev[6].record()
        sync()
        if r:                                   # the first round warms up
            for i, k in enumerate(names):
                total[k] += ev[i].elapsed_time(ev[i + 1]) / reps
    return total


@contextmanager
def counting(module, name: str, calls: Counter):
    """Run with `module.name` wrapped so that each call adds one to
    calls[name]."""
    fn = getattr(module, name)

    def counted(*a, **k):
        calls[name] += 1
        return fn(*a, **k)

    with plain_version(module, name, counted):
        yield


def tombstoned(packed, seed: int, share: float = 0.2):
    """The packed table with `share` of each partition's live slots set to
    -1 in place (seeded): the extent stays, sizes become the live count."""
    ids = packed.part_ids
    g = torch.Generator().manual_seed(seed)
    key = torch.where(ids >= 0, torch.rand(ids.shape, generator=g).to(ids.device), 2.0)
    rank = torch.argsort(torch.argsort(key, dim=1), dim=1)
    dead = rank < (share * packed.sizes.float()).floor().long()[:, None]
    ids = torch.where(dead, -1, ids)
    return packed._replace(part_ids=ids, sizes=(ids >= 0).sum(1).to(torch.int32))


def dense_scan(pq_score, luts, Qb, idx, part, k):
    """Brute-force ADC over every code row: PQ score + ⟨q, c⟩ of the row's
    partition, best row per point, top-k points → ids (nq, k)."""
    s = pq_score(luts, idx.codes) + (Qb @ idx.centroids.T)[:, part]
    best = torch.full((Qb.shape[0], idx.n_points), float("-inf"), device=s.device)
    best.scatter_reduce_(1, idx.point_ids.long().expand(Qb.shape[0], -1), s, "amax")
    return torch.topk(best, k, dim=1).indices


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", type=Path, default=None,
                    help="checkout of the parent commit: time its route and "
                         "dense kernels beside this one's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from repro_torch import faults
    from repro_torch.ckpt import CorruptSnapshotError, MutationWAL
    from repro_torch.core import (build_ivf, build_ivf_sharded, kmr_curve, pack_ivf,
                                  points_to_recall, rank_statistics, recall_at_k,
                                  router as router_mod, search, search_jit_batched,
                                  true_neighbors)
    from repro_torch.core.analysis import (angle_correlation, pair_stats,
                                           score_error_correlation)
    from repro_torch.core import ivf as ivf_mod
    from repro_torch.core import kmeans as kmeans_mod
    from repro_torch.core.build import assign_shards
    from repro_torch.core.kmeans import train_kmeans
    from repro_torch.core.mutable import MutableIVF
    from repro_torch.core.search import search_numpy
    from repro_torch.core.router import FlatRouter
    from repro_torch.data.vectors import make_manifold
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import lloyd as lloyd_mod
    from repro_torch.kernels import soar_assign as soar_mod
    from repro_torch.kernels.lloyd import lloyd_sweep
    from repro_torch.kernels.pq_score import pq_score, pq_score_probes
    from repro_torch.kernels.soar_assign import soar_assign, spill_columns, unit_residuals
    from repro_torch.kernels.tree_route import tree_route
    from repro_torch.kernels.vq_assign import vq_assign
    from repro_torch.quant import anisotropic as aniso_mod
    from repro_torch.quant.int8 import int8_quantize
    from repro_torch.quant.pq import pq_lut
    from repro_torch.serve.api import SearchParams
    from repro_torch.serve.engine import AnnEngine
    from repro_torch.utils import set_f32_precision, topk_first, topk_inner_product

    set_f32_precision()
    wrappers = {"pq_score_probes": pq_score_probes, "vq_assign": vq_assign,
                "soar_assign": soar_assign, "lloyd_sweep": lloyd_sweep,
                "tree_route": tree_route, "pq_score": pq_score}

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
          f"count {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    lib = _build.library_path()
    _build.library()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s")

    # 3. main path: build (tree router included), pack, flat search
    t0 = time.perf_counter()
    ds = make_manifold(args.seed, N, D, nq=NQ, device=DEVICE)
    sync()
    print(f"data: {N} x {D}, {NQ} queries in {time.perf_counter() - t0:.2f} s")
    search_kw = dict(top_t=TOP_T, final_k=FINAL_K, rerank_budget=BUDGET, bq=BQ)

    torch.cuda.reset_peak_memory_stats()
    phases: dict = {}
    times: dict = {}

    def main_path():
        idx, times["build_s"] = timed(lambda: build_ivf_sharded(
            torch.Generator().manual_seed(args.seed), ds.X, C, spill_mode="soar",
            lam=1.0, pq_subspaces=M, rerank="f32", train_sample=TRAIN_SAMPLE,
            shard_size=SHARD, timings=phases, device=DEVICE, router="tree"))
        packed, times["pack_s"] = timed(lambda: pack_ivf(idx))
        flat = FlatRouter(packed.centroids)
        _, times["first_search_s"] = timed(
            lambda: search_jit_batched(packed, ds.Q, router=flat, **search_kw))
        mem["peak_before_warm_search"] = torch.cuda.max_memory_allocated()
        mem["resident_before_warm_search"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (ids, _), times["search_s"] = timed(
            lambda: search_jit_batched(packed, ds.Q, router=flat, **search_kw))
        mem["warm_search_peak"] = torch.cuda.max_memory_allocated()
        return idx, packed, flat, ids

    mem: dict = {}
    (idx, packed, flat, ids), launches = drive(
        wrappers, ("lloyd_sweep", "vq_assign", "soar_assign", "pq_score_probes"),
        main_path)
    lloyd_shapes = dict(lloyd_sweep.shapes)
    peak_mem = max(mem["peak_before_warm_search"], mem["warm_search_peak"])
    rt = idx.router
    pmax = int(packed.part_ids.shape[1])
    sizes = idx.partition_sizes().float()
    gt = true_neighbors(ds.X, ds.Q, k=FINAL_K, chunk=65_536)
    recall = recall_at_k(ids, gt, FINAL_K)
    with plain_version(search, "pq_score_probes", ref.pq_score_probes_ref):
        plain_ids, _ = search_jit_batched(packed, ds.Q, router=flat, **search_kw)
    agree = float((plain_ids == ids).float().mean())
    # the build's assignment against the same shards through the plain versions
    with plain_version(soar_mod, "vq_assign_prepared",
                       lambda X, cb: ref.vq_assign_ref(X, cb.C)), \
            plain_version(soar_mod, "soar_assign_prepared",
                          lambda X, R, P, cb, lam: ref.soar_assign_ref(X, R, P, cb.C, lam)):
        plain_assign = assign_shards(ds.X, idx.centroids, spill_mode="soar", lam=1.0,
                                     shard_size=SHARD)
    assign_agree = [float((plain_assign[:, j] == idx.assignments[:, j]).float().mean())
                    for j in range(idx.assignments.shape[1])]
    del plain_assign
    # four more warm searches: the spread of the host-bound search time
    runs = [times["search_s"]] + [timed(lambda: search_jit_batched(
        packed, ds.Q, router=flat, **search_kw))[1] for _ in range(4)]
    _, times["spill_assign_warm_s"] = timed(lambda: assign_shards(
        ds.X, idx.centroids, spill_mode="soar", lam=1.0, shard_size=SHARD))
    times["assign_fused_shard_ms"] = time_ms(
        lambda: soar_mod.assign_fused(ds.X[:SHARD], idx.centroids, 1.0, 1))
    tiles = -(-NQ // BQ)
    stages = tile_stages(search, packed, ds.Q[:BQ], flat)
    summary = {
        "n": N, "d": D, "nq": NQ, "c": C, "m": M, "top_t": TOP_T,
        "rerank_budget": BUDGET, "bq": BQ, **times, "build_phases_s": phases,
        "qps": NQ / times["search_s"], "search_s_runs": runs,
        "qps_median": NQ / sorted(runs)[2], "recall_at_10": recall,
        "ids_agree_plain_scorer": agree,
        "assignments_agree_plain_by_column": assign_agree,
        "max_memory_allocated_bytes": peak_mem,
        "warm_search_peak_bytes": mem["warm_search_peak"],
        "warm_search_peak_above_resident_bytes":
            mem["warm_search_peak"] - mem["resident_before_warm_search"],
        "tile_stage_ms": stages, "lloyd_launches_by_shape": lloyd_shapes,
        "n_assignments": idx.n_assignments, "pmax": pmax,
        "mean_partition": float(sizes.mean()), "window": TOP_T * pmax,
        "launches": launches,
    }
    print("main path: " + json.dumps(summary))
    assert recall >= 0.85, f"recall@10 {recall} < 0.85"
    assert agree >= 0.99, f"ids agree with the plain scorer on {agree} < 0.99"
    assert min(assign_agree) >= 0.999, \
        f"assignments agree with the plain versions on {assign_agree} < 0.999"
    assert launches["pq_score_probes"] == 2 * tiles, \
        f"window scoring launches {launches} != one per tile of two searches"

    # 4. tree-routed search through the index's router, warm
    search_jit_batched(packed, ds.Q, **search_kw)
    (tids, tsearch_s), tlaunch = drive(
        wrappers, ("tree_route", "pq_score_probes"),
        lambda: timed(lambda: search_jit_batched(packed, ds.Q, **search_kw)[0]))
    truns = [tsearch_s] + [timed(lambda: search_jit_batched(packed, ds.Q, **search_kw))[1]
                           for _ in range(4)]
    trecall = recall_at_k(tids, gt, FINAL_K)
    with plain_version(router_mod, "tree_route",
                       lambda Q, SC, CC, CH, t, **_: ref.tree_route_ref(Q, SC, CC, CH, t)):
        tplain, _ = search_jit_batched(packed, ds.Q, **search_kw)
    tagree = float((tplain == tids).float().mean())
    tree_summary = {
        "n_super": rt.n_super, "t_route": rt.eff_t_route, "cmax": rt.cmax,
        "search_s": tsearch_s, "qps": NQ / tsearch_s, "search_s_runs": truns,
        "qps_median": NQ / sorted(truns)[2], "recall_at_10": trecall,
        "recall_ratio_to_flat": trecall / recall,
        "probe_flops_ratio_to_flat": rt.probe_flops(TOP_T) / flat.probe_flops(TOP_T),
        "ids_agree_plain_route": tagree, "launches": tlaunch,
    }
    print("tree search: " + json.dumps(tree_summary))
    assert trecall >= 0.85, f"tree recall@10 {trecall} < 0.85"
    assert tlaunch["tree_route"] == tiles, f"tree_route launches {tlaunch} != {tiles}"
    assert tagree >= 0.99, f"tree ids agree with the plain route on {tagree} < 0.99"

    # 5. filtered tree-routed search
    perm = torch.randperm(N, generator=torch.Generator().manual_seed(args.seed))
    fsummary = {}
    for sel in SELECTIVITIES:
        keep = perm[:int(N * sel)].sort().values.to(DEVICE)
        bits = torch.zeros(N, dtype=torch.uint8, device=DEVICE)
        bits[keep] = 1
        _, fidx = topk_inner_product(ds.Q, ds.X[keep], FINAL_K, chunk=65_536)
        fgt = keep[fidx.long()].to(torch.int32)
        runs = {}
        for esc in (True, False):
            fids, flaunch = drive(wrappers, ("tree_route", "pq_score_probes"),
                                  lambda: search_jit_batched(packed, ds.Q, filter=bits,
                                                             escalate=esc, **search_kw)[0])
            got = fids[fids >= 0].long()
            assert bool((bits[got] > 0).all()), "a filtered-out id was returned"
            runs["escalated" if esc else "unescalated"] = {
                "recall_at_10": recall_at_k(fids, fgt, FINAL_K),
                "ids_returned_share": float((fids >= 0).float().mean()),
                "launches": flaunch}
        thin = sum(int((search._search_pass(packed, ds.Q[i0:i0 + BQ], rt, TOP_T,
                                            FINAL_K, BUDGET, 2, bits)[2] < BUDGET).sum())
                   for i0 in range(0, NQ, BQ))
        fsummary[str(sel)] = {"kept": int(keep.numel()),
                              "thin_first_pass_share": thin / NQ, **runs}
        assert runs["escalated"]["recall_at_10"] >= runs["unescalated"]["recall_at_10"], \
            f"escalation lowered filtered recall at selectivity {sel}"
    print("filtered search: " + json.dumps(fsummary))

    # 6. dense PQ scan of one tile of queries over every code row
    Qb = ds.Q[:BQ]
    luts = pq_lut(packed.pq, Qb)
    part = torch.repeat_interleave(torch.arange(C, device=DEVICE), idx.partition_sizes())
    dids, dlaunch = drive(wrappers, ("pq_score",),
                          lambda: dense_scan(ops.pq_score, luts, Qb, idx, part, FINAL_K))
    dplain = dense_scan(ref.pq_score_ref, luts, Qb, idx, part, FINAL_K)
    dagree = float((dplain == dids).float().mean())
    dsummary = {"queries": BQ, "rows": idx.n_assignments,
                "recall_at_10": recall_at_k(dids, gt[:BQ], FINAL_K),
                "ids_agree_plain_scorer": dagree, "launches": dlaunch}
    print("dense scan: " + json.dumps(dsummary))
    assert dagree >= 0.99, f"dense ids agree with the plain scorer on {dagree} < 0.99"
    path_launches = Counter()
    for counts in (launches, tlaunch, dlaunch):
        path_launches.update(counts)

    # 7. tombstones inside partitions, searched flat on the card
    tomb = tombstoned(packed, args.seed)
    (tids_t, tomb_s), tomb_launch = drive(
        wrappers, ("pq_score_probes",),
        lambda: timed(lambda: search_jit_batched(tomb, ds.Q, router=flat, **search_kw)[0]))
    path_launches.update(tomb_launch)
    with plain_version(search, "pq_score_probes", ref.pq_score_probes_ref):
        tplain_t, _ = search_jit_batched(tomb, ds.Q, router=flat, **search_kw)
    live_slots = tomb.sizes[flat.route(ds.Q, TOP_T)[1]].sum(-1)
    enough = live_slots >= 2 * FINAL_K
    tomb_summary = {
        "dead_slots": int((packed.part_ids >= 0).sum() - (tomb.part_ids >= 0).sum()),
        "slots_past_live_count": int((tomb.extent - tomb.sizes).sum()),
        "rows_with_2k_live_slots": int(enough.sum()),
        "minus1_in_those_rows": int((tids_t[enough] < 0).sum()),
        "ids_agree_plain_scorer": float((tplain_t == tids_t).float().mean()),
        "recall_at_10_vs_untombstoned_gt": recall_at_k(tids_t, gt, FINAL_K),
        "search_s": tomb_s, "launches": tomb_launch}
    print("tombstones: " + json.dumps(tomb_summary))
    assert tomb_summary["minus1_in_those_rows"] == 0, "a -1 came back while live points remained"
    assert tomb_summary["ids_agree_plain_scorer"] >= 0.99, \
        f"tombstoned ids agree with the plain scorer on {tomb_summary['ids_agree_plain_scorer']}"
    del tomb, tids_t, tplain_t

    # 8. k-means modes on the training sample
    Xt = ds.X[:TRAIN_SAMPLE].contiguous()
    modes = {"parallel": dict(init="parallel"), "minibatch": dict(batch_size=16_384),
             "spherical": dict(spherical=True), "pp": {}}
    ksummary = {}
    for name, kw in modes.items():
        (res, secs), klaunch = drive(wrappers, ("lloyd_sweep",), lambda: timed(
            lambda: train_kmeans(torch.Generator().manual_seed(args.seed), Xt, C, **kw)))
        path_launches.update(klaunch)
        ksummary[name] = {"distortion": float(res.distortion), "seconds": secs,
                          "sweeps": len(res.history), "launches": klaunch}
    with plain_version(kmeans_mod, "lloyd_sweep", ref.lloyd_sweep_ref):
        res, secs = timed(lambda: train_kmeans(torch.Generator().manual_seed(args.seed), Xt, C))
    ksummary["plain_lloyd"] = {"distortion": float(res.distortion), "seconds": secs,
                               "sweeps": len(res.history)}
    print("k-means modes: " + json.dumps(ksummary))
    for name in ("parallel", "minibatch"):
        assert ksummary[name]["distortion"] <= 1.05 * ksummary["pp"]["distortion"], \
            f"{name} k-means distortion more than 5% above the baseline's"

    # 9-10. the variants' builds, with their plain-torch work counted
    plain_calls: Counter = Counter()
    counted = ((soar_mod, "spill_columns"), (aniso_mod, "anisotropic_assign"),
               (aniso_mod, "_anisotropic_update"), (ivf_mod, "int8_quantize"))

    def variant(build):
        """Build, pack and search twice (cold, warm) → (index, packed, ids,
        numbers); peak memory over the whole variant."""
        out = {"build_phases_s": {}}
        torch.cuda.reset_peak_memory_stats()
        out["resident_before_bytes"] = torch.cuda.memory_allocated()
        with ExitStack() as stack:
            for mod, name in counted:
                stack.enter_context(counting(mod, name, plain_calls))
            vidx, out["build_s"] = timed(lambda: build(out["build_phases_s"]))
        vpacked = pack_ivf(vidx)
        vflat = FlatRouter(vpacked.centroids)
        _, out["first_search_s"] = timed(
            lambda: search_jit_batched(vpacked, ds.Q, router=vflat, **search_kw))
        (vids, _), out["search_s"] = timed(
            lambda: search_jit_batched(vpacked, ds.Q, router=vflat, **search_kw))
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        out["search_s_runs"] = [out["search_s"]] + [timed(lambda: search_jit_batched(
            vpacked, ds.Q, router=vflat, **search_kw))[1] for _ in range(4)]
        out["qps"] = NQ / out["search_s"]
        out["qps_median"] = NQ / sorted(out["search_s_runs"])[2]
        out["recall_at_10"] = recall_at_k(vids, gt, FINAL_K)
        out["main_path_recall_at_10"] = recall
        out["n_assignments"] = vidx.n_assignments
        return vidx, out

    (aidx, asum), alaunch = drive(
        wrappers, ("lloyd_sweep", "vq_assign", "soar_assign", "pq_score_probes"),
        lambda: variant(lambda ph: build_ivf_sharded(
            torch.Generator().manual_seed(args.seed), ds.X, C, spill_mode="soar",
            n_spills=2, lam=1.0, anisotropic_T=ANISO_T, rerank="int8", pq_subspaces=M,
            train_sample=TRAIN_SAMPLE, shard_size=SHARD, timings=ph, device=DEVICE)))
    path_launches.update(alaunch)
    a = aidx.assignments
    srt = torch.sort(a, dim=1).values
    with plain_version(soar_mod, "vq_assign_prepared",
                       lambda X, cb: ref.vq_assign_ref(X, cb.C)), \
            plain_version(soar_mod, "soar_assign_prepared",
                          lambda X, R, P, cb, lam: ref.soar_assign_ref(X, R, P, cb.C, lam)):
        aplain = assign_shards(ds.X, aidx.centroids, spill_mode="soar", lam=1.0,
                               n_spills=2, shard_size=SHARD)
    qcpu = int8_quantize(ds.X[:SHARD].cpu())
    asum.update({
        "memory_bytes_int8": aidx.memory_bytes("int8"),
        "columns_distinct": bool((srt[:, 1:] != srt[:, :-1]).all()),
        "assignments_agree_plain_by_column":
            [float((aplain[:, j] == a[:, j]).float().mean()) for j in range(3)],
        "int8_equal_cpu_first_rows":
            bool(torch.equal(aidx.rerank_int8.q[:SHARD].cpu(), qcpu.q)
                 and torch.equal(aidx.rerank_int8.scale[:SHARD].cpu(), qcpu.scale)),
        "launches": alaunch})
    print("variant A: " + json.dumps(asum))
    assert asum["recall_at_10"] >= 0.85, f"variant A recall@10 {asum['recall_at_10']} < 0.85"
    assert asum["columns_distinct"], "variant A: a row has two equal columns"
    assert min(asum["assignments_agree_plain_by_column"]) >= 0.999, \
        f"variant A columns agree with the plain versions on " \
        f"{asum['assignments_agree_plain_by_column']} < 0.999"
    assert asum["int8_equal_cpu_first_rows"], "variant A int8 rows differ from the CPU's"
    del aidx, aplain, a, srt

    (bidx, bsum), blaunch = drive(
        wrappers, ("lloyd_sweep", "soar_assign", "pq_score_probes"),
        lambda: variant(lambda ph: build_ivf(
            torch.Generator().manual_seed(args.seed), ds.X, C, spill_mode="soar",
            n_spills=1, anisotropic_T=ANISO_T, rerank="f32", pq_subspaces=M,
            timings=ph, device=DEVICE)))
    path_launches.update(blaunch)
    bprim = bidx.assignments[:, 0].contiguous()
    bspill = ref.soar_assign_ref(ds.X, unit_residuals(ds.X, bidx.centroids, bprim),
                                 bprim, bidx.centroids, 1.0)[0]
    bsum.update({"spill_agree_plain": float((bspill == bidx.assignments[:, 1]).float().mean()),
                 "launches": blaunch})
    print("variant B: " + json.dumps(bsum))
    assert bsum["recall_at_10"] >= 0.85, f"variant B recall@10 {bsum['recall_at_10']} < 0.85"
    assert bsum["spill_agree_plain"] >= 0.999, \
        f"variant B spills agree with soar_assign_ref on {bsum['spill_agree_plain']} < 0.999"
    del bidx, bspill, bprim

    # 11. serving: the main index behind AnnEngine, mutated online
    def serving():
        """Wrap the main index, search, churn it, soft-remove, harden and
        compact, rebuild, run the host engine → numbers (checks below)."""
        out = {}
        torch.cuda.reset_peak_memory_stats()
        out["resident_before_bytes"] = torch.cuda.memory_allocated()
        mut, out["wrap_s"] = timed(lambda: MutableIVF.from_index(idx))
        eng = AnnEngine(mut, top_t=TOP_T, rerank_budget=BUDGET, bq=BQ)
        Qn = ds.Q.cpu().numpy()
        out["capacity"] = {"slots": int(mut.part_ids.shape[1]), "pmax": pmax,
                           "rerank_rows": int(mut.rerank.shape[0])}
        _, out["first_search_s"] = timed(lambda: eng.search(Qn, k=FINAL_K))
        r, out["search_s"] = timed(lambda: eng.search_request(Qn, SearchParams(k=FINAL_K)))
        out["qps"] = NQ / out["search_s"]
        out["engine_us"] = r.engine_us
        out["ids_agree_tree_search"] = float((torch.from_numpy(r.ids) == tids.cpu())
                                             .float().mean())
        g = torch.Generator().manual_seed(args.seed + 1)
        dead, rounds = [], []
        out["returned_removed"] = 0

        def n_dead(ids):
            """How many of the (numpy) result ids were removed."""
            return int(torch.isin(torch.from_numpy(ids).long(), torch.cat(dead)).sum())

        def delta_matches_full(delta) -> bool:
            """The delta pack against a full repack. Its ids, codes and
            rerank rows are the index's own tensors (a view, the same by
            construction); what the delta computes — sizes, extent and the
            pruned router's children — must equal the repack's."""
            view = all(a.data_ptr() == b.data_ptr() for a, b in (
                (delta.part_ids, mut.part_ids), (delta.part_codes, mut.part_codes),
                (delta.rerank, mut.rerank)))
            mut.invalidate_snapshots()
            full = mut.pack()
            return view and full is not delta and all(torch.equal(a, b) for a, b in (
                (delta.sizes, full.sizes), (delta.extent, full.extent),
                (delta.router.children, full.router.children)))

        same_assign = delta_equal = via_delta = 0
        for _ in range(ROUNDS):
            live = torch.nonzero(mut.alive[:mut.n_total]).reshape(-1)
            victims = live[torch.randperm(live.numel(), generator=g)[:CHURN].to(DEVICE)]
            vecs = mut.rerank[victims].clone()
            before = mut.assignments[victims].clone()
            t = {}
            _, t["remove"] = timed(lambda: eng.remove(victims))
            new, t["add"] = timed(lambda: eng.add(vecs))
            via_delta += mut._packed is not None and mut._dirty_parts is not None
            delta, t["pack"] = timed(mut.pack)
            res, t["search"] = timed(lambda: eng.search_request(
                Qn[:BQ], SearchParams(k=FINAL_K)))
            rounds.append({f"{k}_ms": v * 1e3 for k, v in t.items()})
            dead.append(victims.cpu())
            newt = torch.from_numpy(new).to(DEVICE).long()
            same_assign += int((mut.assignments[newt] == before).all(dim=1).sum())
            delta_equal += int(delta_matches_full(delta))
            out["returned_removed"] += n_dead(res.ids)
        out["rounds_ms"] = rounds
        out["rounds_ms_median"] = {k: sorted(r_[k] for r_ in rounds)[ROUNDS // 2]
                                   for k in rounds[0]}
        out["readded_same_assignments_share"] = same_assign / (ROUNDS * CHURN)
        out["delta_pack_equal_rounds"] = delta_equal
        out["rounds_through_delta"] = via_delta      # the first grows the rows
        out["rerank_rows_after_churn"] = int(mut.rerank.shape[0])
        out["peak_after_rounds_bytes"] = torch.cuda.max_memory_allocated()
        # the last round's re-added vectors, searched for themselves
        own, _ = eng.search(vecs.cpu().numpy(), k=FINAL_K)
        out["readded_in_own_top10"] = float((own == new[:, None]).any(1).mean())
        out["readded_top1"] = float((own[:, 0] == new).mean())
        # prune: empty every child of the super most queries rank first, and
        # one child of the next, so the served router holds a super with no
        # child left and a -1 inside a row; then re-add them, which un-prunes
        trained, served = mut.router, mut.pack().router
        first = torch.bincount((ds.Q @ trained.super_centroids.T).argmax(1),
                               minlength=trained.n_super)
        s1, s2 = torch.topk(first, 2).indices.tolist()
        ch1, ch2 = served.children[s1], served.children[s2]
        emptied = torch.cat([ch1[ch1 >= 0], ch2[ch2 >= 0][:1]]).long()
        slots = mut.part_ids[emptied]
        gone = torch.unique(slots[slots >= 0])
        gone_vecs, gone_assign = mut.rerank[gone].clone(), mut.assignments[gone].clone()
        _, out["prune_remove_ms"] = timed(lambda: eng.remove(gone))
        out["prune_through_delta"] = mut._packed is not None and mut._dirty_parts is not None
        pruned, out["prune_pack_ms"] = timed(mut.pack)
        pch = pruned.router.children
        out["prune"] = {
            "supers": [s1, s2], "partitions_emptied": int(emptied.numel()),
            "ids_removed": int(gone.numel()),
            "children_pruned": int(((pch < 0) & (served.children >= 0)).sum()),
            "queries_reaching_emptied_super": int(
                (torch.topk(ds.Q @ trained.super_centroids.T, trained.eff_t_route).indices
                 == s1).any(1).sum())}
        out["prune_shape_ok"] = (pruned.router is not served and bool((pch[s1] < 0).all())
                                 and int((pch[s2] < 0).sum()) == int((ch2 < 0).sum()) + 1)
        live_parts = (mut.part_ids >= 0).any(dim=1)

        class LiveOnly(type(trained)):
            """The trained tables' route with dead partitions' candidates
            at -inf: the tree search restricted to live partitions,
            reckoned without `pruned`."""

            def route(self, Q, top_t):
                sc, cand = tree_route(Q, self.super_centroids, self.child_centroids,
                                      self.children, self.eff_t_route, checked=True)
                dead_c = (cand >= 0) & ~live_parts[cand.clamp(min=0).long()]
                v, pos = topk_first(sc.masked_fill(dead_c, float("-inf")),
                                    min(top_t, sc.shape[-1]))
                return v, torch.gather(cand, -1, pos).clamp(min=0)

        pr, out["pruned_search_s"] = timed(lambda: eng.search_request(
            Qn, SearchParams(k=FINAL_K)))
        lids, _ = search_jit_batched(pruned, ds.Q, router=LiveOnly(
            trained.super_centroids, trained.children, trained.child_centroids,
            trained.t_route, trained.n_partitions), **search_kw)
        out["pruned_ids_agree_live_route"] = float(
            (torch.from_numpy(pr.ids) == lids.cpu()).float().mean())
        dead.append(gone.cpu())
        out["returned_removed"] += n_dead(pr.ids)
        out["prune_delta_equal"] = delta_matches_full(pruned)
        back, out["prune_readd_ms"] = timed(lambda: eng.add(gone_vecs))
        back = torch.from_numpy(back).to(DEVICE).long()
        out["prune_readd_same_assignments_share"] = float(
            (mut.assignments[back] == gone_assign).all(dim=1).float().mean())
        out["unpruned_after_readd"] = torch.equal(mut.pack().router.children,
                                                  served.children)
        for k in ("prune_remove_ms", "prune_pack_ms", "prune_readd_ms"):
            out[k] *= 1e3
        # soft removal through the standing filter, then harden and compact
        live = torch.nonzero(mut.alive[:mut.n_total]).reshape(-1)
        soft = live[torch.randperm(live.numel(), generator=g)[:SOFT].to(DEVICE)]
        _, out["soft_remove_ms"] = timed(lambda: eng.remove(soft, hard=False))
        (fids, _), out["filtered_search_s"] = timed(lambda: eng.search(Qn, k=FINAL_K))
        dead.append(soft.cpu())
        out["returned_removed"] += n_dead(fids)
        out["hardened"], out["harden_ms"] = timed(mut.harden_soft_deletes)
        _, out["compact_ms"] = timed(mut.compact)
        out["harden_ms"] *= 1e3
        out["compact_ms"] *= 1e3
        out["soft_remove_ms"] *= 1e3
        (eids, _), out["search_after_compact_s"] = timed(lambda: eng.search(Qn, k=FINAL_K))
        out["returned_removed"] += n_dead(eids)
        # the rebuilt reference: the live rows from scratch on the frozen stages
        live = torch.nonzero(mut.alive[:mut.n_total]).reshape(-1)
        ref_idx, out["rebuild_s"] = timed(lambda: mut.rebuild_reference(
            torch.Generator().manual_seed(args.seed)))
        rids, _ = search_jit_batched(pack_ivf(ref_idx), ds.Q, **search_kw)
        id_map = torch.full((mut.n_total,), -1, dtype=torch.int64, device=DEVICE)
        id_map[live] = torch.arange(live.numel(), device=DEVICE)
        e = torch.from_numpy(eids).to(DEVICE).long()
        mapped = torch.where(e >= 0, id_map[e.clamp(min=0)], -1)
        out["rebuilt_ids_agree"] = float((mapped == rids.long()).float().mean())
        del ref_idx, rids
        # the host engine over the CSR snapshot, against exact search of the live rows
        csr = mut.to_ivf_index()
        Qh = ds.Q[:HOST_NQ]
        _, gidx = topk_inner_product(Qh, mut.rerank[live], FINAL_K, chunk=65_536)
        hgt = live[gidx.long()].to(torch.int32)
        host = lambda: search_numpy(csr, Qh, top_t=TOP_T, final_k=FINAL_K,  # noqa: E731
                                    rerank_budget=BUDGET)
        _, out["host_first_s"] = timed(host)
        (hids, hstats), out["host_s"] = timed(host)
        out["host_qps"] = HOST_NQ / out["host_s"]
        out["host_recall_at_10"] = recall_at_k(hids, hgt, FINAL_K)
        out["engine_recall_at_10_same_queries"] = recall_at_k(
            torch.from_numpy(eids[:HOST_NQ]).to(DEVICE), hgt, FINAL_K)
        out["host_ids_agree_engine"] = float((hids.cpu() == torch.from_numpy(
            eids[:HOST_NQ])).float().mean())
        out["host_mean_points_read"] = float(hstats.points_read.float().mean())
        out["n_alive"], out["n_total"] = mut.n_alive, mut.n_total
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        return out, eng

    (ssum, eng), slaunch = drive(wrappers, ("vq_assign", "soar_assign", "tree_route",
                                     "pq_score_probes"), serving)
    path_launches.update(slaunch)
    ssum["launches"] = slaunch
    print("serving: " + json.dumps(ssum))
    assert ssum["returned_removed"] == 0, "a removed id was returned"
    assert ssum["readded_in_own_top10"] >= 0.9, \
        f"re-added vectors in their own top 10 on {ssum['readded_in_own_top10']} < 0.9"
    assert ssum["delta_pack_equal_rounds"] == ROUNDS, "a delta pack differs from the full repack"
    assert ssum["rounds_through_delta"] >= ROUNDS - 1 and ssum["prune_through_delta"], \
        "a round's pack did not go through the delta path"
    assert ssum["prune_shape_ok"], f"the served router is not pruned as expected: {ssum['prune']}"
    assert ssum["prune"]["queries_reaching_emptied_super"] > 0, "no query reaches the emptied super"
    assert ssum["pruned_ids_agree_live_route"] >= 0.999, \
        f"pruned engine ids agree with the live-only tree search on " \
        f"{ssum['pruned_ids_agree_live_route']} < 0.999"
    assert ssum["prune_delta_equal"], "the pruned delta pack differs from the full repack"
    assert ssum["unpruned_after_readd"], "re-adding the emptied partitions left the router pruned"
    assert ssum["ids_agree_tree_search"] >= 0.999, \
        f"engine ids agree with the tree search on {ssum['ids_agree_tree_search']} < 0.999"
    assert ssum["rebuilt_ids_agree"] >= 0.999, \
        f"rebuilt ids agree with the engine's on {ssum['rebuilt_ids_agree']} < 0.999"
    assert ssum["host_recall_at_10"] >= 0.85, \
        f"host engine recall@10 {ssum['host_recall_at_10']} < 0.85"

    # 12. the paper metrics: KMR curves of three spill modes on one codebook,
    # rank statistics, the residual correlations
    def paper_metrics():
        """KMR curves of the main index and of its codebook's none and naive
        builds, rank statistics against the CPU, pair statistics → numbers."""
        out = {}
        torch.cuda.reset_peak_memory_stats()
        out["resident_before_bytes"] = torch.cuda.memory_allocated()
        t_phase = time.perf_counter()
        tid, out["true_neighbors_s"] = timed(
            lambda: true_neighbors(ds.X, ds.Q, k=KMR_K, chunk=65_536))
        builds = {"soar": idx}
        for mode in ("none", "naive"):
            builds[mode], out[f"build_{mode}_s"] = timed(lambda: build_ivf_sharded(
                torch.Generator().manual_seed(args.seed), ds.X, C, spill_mode=mode,
                pq_subspaces=M, rerank="f32", codebook=idx.centroids, pq=idx.pq,
                shard_size=SHARD, device=DEVICE))
        out["primary_equal_main_share"] = {
            mode: float((builds[mode].assignments[:, 0] == idx.assignments[:, 0])
                        .float().mean()) for mode in ("none", "naive")}
        curves, out["curves"] = {}, {}
        for mode, ix in builds.items():
            cv, secs = timed(lambda: kmr_curve(ix, ds.Q, tid, k=KMR_K))
            r, pts = cv.recall_at_t, cv.points_at_t
            curves[mode] = cv
            out["curves"][mode] = {
                "kmr_s": secs, "n_assignments": ix.n_assignments,
                "points_to_recall": {str(t): points_to_recall(cv, t) for t in KMR_TARGETS},
                "recall_at_t": {str(t): float(r[t - 1]) for t in (1, 10, TOP_T, 2 * TOP_T)},
                "non_decreasing": bool(np.all(np.diff(r) >= 0)),
                "last_recall": float(r[-1]), "last_points": float(pts[-1])}
        out["spill_dominates_none"] = {
            mode: bool(np.all(curves[mode].recall_at_t >= curves["none"].recall_at_t))
            for mode in ("naive", "soar")}
        # rank statistics of the first queries on the card and on CPU copies
        nr = RANK_NQ
        gp, gs = rank_statistics(idx, ds.Q[:nr], tid[:nr])
        host = SimpleNamespace(centroids=idx.centroids.cpu(),
                               assignments=idx.assignments.cpu())
        wp, ws = rank_statistics(host, ds.Q[:nr].cpu(), tid[:nr].cpu())
        out["rank_stats_agree_cpu"] = [float((gp.cpu() == wp).float().mean()),
                                       float((gs.cpu() == ws).float().mean())]
        out["mean_primary_rank"] = float(gp.float().mean())
        out["mean_spill_rank"] = float(gs.float().mean())
        out["correlations"] = {}
        for mode in ("naive", "soar"):
            st, secs = timed(lambda: pair_stats(ds.X, builds[mode].centroids,
                                                builds[mode].assignments, ds.Q, tid))
            out["correlations"][mode] = {
                "score_error": score_error_correlation(st),
                "angle": angle_correlation(st), "pair_stats_s": secs}
            del st
        del builds["none"], builds["naive"], tid
        out["phase_s"] = time.perf_counter() - t_phase
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        return out, curves

    (ksum, curves), klaunch = drive(wrappers, ("vq_assign", "soar_assign"), paper_metrics)
    path_launches.update(klaunch)
    ksum["launches"] = klaunch
    torch.cuda.empty_cache()
    print("paper metrics: " + json.dumps(ksum))
    for mode, cv in ksum["curves"].items():
        assert cv["non_decreasing"], f"{mode}: the KMR curve decreases"
        assert abs(cv["last_recall"] - 1.0) <= 1e-6, f"{mode}: the curve ends at {cv['last_recall']}"
        assert abs(cv["last_points"] - cv["n_assignments"]) <= 1e-5 * cv["n_assignments"], \
            f"{mode}: the curve ends at {cv['last_points']} points, not {cv['n_assignments']}"
    assert all(ksum["spill_dominates_none"].values()), \
        f"a spilled curve falls below none's: {ksum['spill_dominates_none']}"
    assert min(ksum["rank_stats_agree_cpu"]) >= 0.999, \
        f"rank statistics agree with the CPU's on {ksum['rank_stats_agree_cpu']} < 0.999"

    # 13. durability: the serving engine saved, reopened, logged, replayed
    def durability(tmp):
        """Save phase 11's engine, open it, log a mutation script, replay
        it into a second engine, corrupt the snapshot → numbers."""
        out = {}
        torch.cuda.reset_peak_memory_stats()
        out["resident_before_bytes"] = torch.cuda.memory_allocated()
        mut, Qn = eng.index, ds.Q.cpu().numpy()
        out["capacity"] = {"slots": int(mut.part_ids.shape[1]),
                           "rerank_rows": int(mut.rerank.shape[0])}
        path = os.path.join(tmp, "engine")
        _, out["save_s"] = timed(lambda: eng.save(path))
        arrays_bin = os.path.join(path, "index", "arrays.bin")
        out["snapshot_bytes"] = sum(os.path.getsize(os.path.join(path, "index", f))
                                    for f in ("arrays.bin", "manifest.json"))
        out["save_gb_s"] = out["snapshot_bytes"] / out["save_s"] / 1e9
        opened, out["open_s"] = timed(lambda: AnnEngine.open(path, device=DEVICE))
        out["open_gb_s"] = out["snapshot_bytes"] / out["open_s"] / 1e9
        out["opened_equal"] = same_state(opened.index, mut)
        ids0, _ = eng.search(Qn, k=FINAL_K)
        (oids, _), out["opened_search_s"] = timed(lambda: opened.search(Qn, k=FINAL_K))
        out["opened_ids_agree"] = float((oids == ids0).mean())
        del opened
        # the log: three rounds of hard removals and re-adds, then soft
        # removals and harden, each record appended before it applies
        mut.attach_wal(MutationWAL(os.path.join(path, "wal.log"), fsync="always",
                                   start_seq=mut.wal_seq))
        g = torch.Generator().manual_seed(args.seed + 2)
        steps = []
        for _ in range(WAL_ROUNDS):
            live = torch.nonzero(mut.alive[:mut.n_total]).reshape(-1)
            victims = live[torch.randperm(live.numel(), generator=g)[:CHURN].to(DEVICE)]
            vecs = mut.rerank[victims].clone()
            t = {}
            _, t["remove"] = timed(lambda: eng.remove(victims))
            _, t["add"] = timed(lambda: eng.add(vecs))
            steps.append({f"{k}_ms": v * 1e3 for k, v in t.items()})
        live = torch.nonzero(mut.alive[:mut.n_total]).reshape(-1)
        soft = live[torch.randperm(live.numel(), generator=g)[:CHURN].to(DEVICE)]
        _, out["soft_remove_ms"] = timed(lambda: eng.remove(soft, hard=False))
        _, out["harden_ms"] = timed(mut.harden_soft_deletes)
        out["soft_remove_ms"] *= 1e3
        out["harden_ms"] *= 1e3
        out["logged_rounds_ms"] = steps
        out["wal_seq"] = mut.wal_seq
        out["wal_bytes"] = os.path.getsize(os.path.join(path, "wal.log"))
        # replay: the snapshot plus the log, into a second engine
        n0 = (vq_assign.launches, soar_assign.launches)
        replayed, out["replay_open_s"] = timed(lambda: AnnEngine.open(path, device=DEVICE))
        out["replay_launches"] = {"vq_assign": vq_assign.launches - n0[0],
                                  "soar_assign": soar_assign.launches - n0[1]}
        out["replayed_equal"] = same_state(replayed.index, mut)
        ids1, _ = eng.search(Qn, k=FINAL_K)
        rids, _ = replayed.search(Qn, k=FINAL_K)
        out["replayed_ids_agree"] = float((rids == ids1).mean())
        replayed.index._wal.close()
        mut._wal.close()
        mut._wal = None
        del replayed
        # one flipped byte of arrays.bin: the next open must refuse it
        faults.flip_byte(arrays_bin, os.path.getsize(arrays_bin) // 2)
        try:
            AnnEngine.open(path, device=DEVICE)
            out["corrupt_open_raised"] = False
        except CorruptSnapshotError:
            out["corrupt_open_raised"] = True
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        return out

    def same_state(a, b) -> bool:
        """Two MutableIVFs equal bit for bit: state tensors, counters,
        wal_seq and the router's trained tables."""
        tensors = all(torch.equal(getattr(a, k), getattr(b, k)) for k in (
            "centroids", "part_ids", "part_codes", "sizes", "rerank", "assignments",
            "alive")) and torch.equal(a.pq.centers, b.pq.centers)
        router = all(torch.equal(getattr(a.router, k), getattr(b.router, k)) for k in (
            "super_centroids", "children", "child_centroids"))
        counts = all(getattr(a, k) == getattr(b, k) for k in (
            "n_total", "n_dead_slots", "n_soft_deleted", "wal_seq"))
        return tensors and router and counts

    with tempfile.TemporaryDirectory() as tmp:
        dsum, dlaunch = drive(wrappers, ("vq_assign", "soar_assign", "tree_route",
                                         "pq_score_probes"), lambda: durability(tmp))
    path_launches.update(dlaunch)
    dsum["launches"] = dlaunch
    print("durability: " + json.dumps(dsum))
    assert dsum["opened_equal"], "the opened engine differs from the saved one"
    assert dsum["opened_ids_agree"] == 1.0, \
        f"the opened engine's ids agree on {dsum['opened_ids_agree']} < 1.0"
    assert dsum["wal_seq"] == 2 * WAL_ROUNDS + 2, f"wal_seq {dsum['wal_seq']}"
    assert dsum["replayed_equal"], "the replayed engine differs from the live one"
    assert dsum["replayed_ids_agree"] == 1.0, \
        f"the replayed engine's ids agree on {dsum['replayed_ids_agree']} < 1.0"
    assert min(dsum["replay_launches"].values()) > 0, \
        f"the replayed adds did not launch the assignment kernels: {dsum['replay_launches']}"
    assert dsum["corrupt_open_raised"], "a flipped byte of arrays.bin opened without an error"
    del eng

    # 14. each kernel against its plain version, on the paths' inputs
    kernels = []

    def record(name, source, replaces, err, ms, plain_ms, nbytes, ops_, mm_ops=0.0,
               **extra):
        b_ms, b_by = bound(nbytes, ops_, mm_ops)
        if mm_ops:
            extra["bound_simt_ms"] = bound(nbytes, ops_ + mm_ops)[0]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": path_launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                        "share": b_ms / ms, **extra})
        print(f"kernel {name}: err {err:.3g} ms {ms:.4f} plain {plain_ms:.4f} "
              f"bound {b_ms:.4f} ({b_by}) {extra}")

    # every device time below queues each round behind this longer kernel
    Cb = idx.centroids.contiguous()
    busy = lambda: lloyd_mod.assign_phase(Xt, Cb)   # noqa: E731
    par = parent_build(args.parent.resolve()) if args.parent else None

    # kernel 1: one tile of LUTs against the first DENSE_ROWS code rows
    codes = idx.codes[:DENSE_ROWS]
    got, want = pq_score(luts, codes), ref.pq_score_ref(luts, codes)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5), "pq_score"
    assert torch.equal(pq_score(luts, codes), got), "pq_score is not bitwise repeatable"
    nr = codes.shape[0]

    def parent_pq():
        out = torch.empty((BQ, nr), device=DEVICE)
        par.launch("pq_score_launch", luts, codes, BQ, nr, M, out)
        return out

    if par is not None:
        assert torch.allclose(parent_pq(), want, rtol=1e-5, atol=1e-5), "parent pq_score"
    record("pq_score", "src/repro_torch/csrc/pq_score.cu",
           "src/repro/kernels/pq_score.py:66", float((got - want).abs().max()),
           device_ms(lambda: pq_score(luts, codes), busy),
           time_ms(lambda: ref.pq_score_ref(luts, codes), 3),
           codes.numel() + luts.numel() * 4 + got.numel() * 4,
           got.numel() * M, shape=[BQ, nr, M],
           parent_ms=device_ms(parent_pq, busy) if par else None,
           lookup_floor_ms=got.numel() * M / (SMEM_WORDS_CLK * n_sms * sm_mhz * 1e6) * 1e3,
           sms=n_sms, sm_max_mhz=sm_mhz)
    del got, want

    # kernel 2: one bq tile's real probes, read from the packed table
    psc, parts = flat.route(Qb, TOP_T)
    pargs = (luts, packed.part_codes, packed.extent, parts, psc)
    got, want = pq_score_probes(*pargs), ref.pq_score_probes_ref(*pargs)
    fin = torch.isfinite(want)
    assert torch.equal(torch.isinf(got), torch.isinf(want)), "pq_score_probes -inf slots"
    assert torch.allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5), "pq_score_probes"
    code_bytes = int(packed.extent[parts].sum()) * M     # the rows probed
    record("pq_score_probes", "src/repro_torch/csrc/pq_score_probes.cu",
           "src/repro/kernels/pq_score.py:116",
           float((got[fin] - want[fin]).abs().max()),
           time_ms(lambda: pq_score_probes(*pargs)),
           time_ms(lambda: ref.pq_score_probes_ref(*pargs), 3),
           code_bytes + luts.numel() * 4 + parts.numel() * 8 + psc.numel() * 4
           + got.numel() * 4, code_bytes, shape=[BQ, TOP_T, pmax, M],
           probed_code_bytes=code_bytes)
    # kernels 3 and 4: one assignment shard against the trained codebook,
    # and the online inserts' batch of CHURN rows (MutableIVF.add)
    Xs = ds.X[:SHARD].contiguous()
    n, c, d = Xs.shape[0], Cb.shape[0], Xs.shape[1]
    Xo = ds.X[SHARD:SHARD + CHURN].contiguous()

    def online(got, want, fn, plain_fn, nbytes, ops_, mm_ops):
        """The kernel at the online batch against its plain version."""
        agree = float((got[0] == want[0]).float().mean())
        assert agree >= 0.999 and torch.allclose(got[1], want[1], rtol=1e-4, atol=1e-4), \
            "assignment kernel at the online batch"
        b_ms, b_by = bound(nbytes, ops_, mm_ops)
        return {"shape": [CHURN, c, d], "ms": time_ms(fn), "plain_ms": time_ms(plain_fn),
                "bound_ms": b_ms, "bound_by": b_by, "index_agreement": agree,
                "max_abs_err": float((got[1] - want[1]).abs().max())}

    gi, gv = vq_assign(Xs, Cb)
    wi, wv = ref.vq_assign_ref(Xs, Cb)
    vq_agree = float((gi == wi).float().mean())
    assert vq_agree >= 0.999 and torch.allclose(gv, wv, rtol=1e-4, atol=1e-4), "vq_assign"
    assert not torch.backends.cuda.matmul.allow_tf32, "product_ms needs f32 products"
    record("vq_assign", "src/repro_torch/csrc/vq_assign.cu",
           "src/repro/kernels/vq_assign.py:56", float((gv - wv).abs().max()),
           time_ms(lambda: vq_assign(Xs, Cb)),
           time_ms(lambda: ref.vq_assign_ref(Xs, Cb)),
           (n * d + c * d) * 4 + n * 8, 0, 2 * n * c * d,
           product_ms=time_ms(lambda: torch.mm(Xs, Cb.T)),
           tile_loop="src/repro_torch/csrc/assign_tc.cuh",
           index_agreement=vq_agree, shape=[n, c, d],
           online=online(vq_assign(Xo, Cb), ref.vq_assign_ref(Xo, Cb),
                         lambda: vq_assign(Xo, Cb), lambda: ref.vq_assign_ref(Xo, Cb),
                         (CHURN * d + c * d) * 4 + CHURN * 8, 0, 2 * CHURN * c * d))

    r = Xs - Cb[wi.long()]
    rhat = (r / torch.linalg.vector_norm(r, dim=-1, keepdim=True).clamp(min=1e-12)).contiguous()
    gi, gv = soar_assign(Xs, rhat, wi, Cb, 1.0)
    si, sv = ref.soar_assign_ref(Xs, rhat, wi, Cb, 1.0)
    soar_agree = float((gi == si).float().mean())
    assert soar_agree >= 0.999 and torch.allclose(gv, sv, rtol=1e-4, atol=1e-4), "soar_assign"
    assert not bool((gi == wi).any()), "soar_assign returned a primary"
    wo = ref.vq_assign_ref(Xo, Cb)[0]
    rho = unit_residuals(Xo, Cb, wo).contiguous()
    record("soar_assign", "src/repro_torch/csrc/soar_assign.cu",
           "src/repro/kernels/soar_assign.py:63", float((gv - sv).abs().max()),
           time_ms(lambda: soar_assign(Xs, rhat, wi, Cb, 1.0)),
           time_ms(lambda: ref.soar_assign_ref(Xs, rhat, wi, Cb, 1.0)),
           (2 * n * d + c * d) * 4 + n * 12, 6 * n * c, 4 * n * c * d,
           product_ms=time_ms(lambda: (torch.mm(Xs, Cb.T), torch.mm(rhat, Cb.T))),
           tile_loop="src/repro_torch/csrc/assign_tc.cuh",
           index_agreement=soar_agree, shape=[n, c, d],
           online=online(soar_assign(Xo, rho, wo, Cb, 1.0),
                         ref.soar_assign_ref(Xo, rho, wo, Cb, 1.0),
                         lambda: soar_assign(Xo, rho, wo, Cb, 1.0),
                         lambda: ref.soar_assign_ref(Xo, rho, wo, Cb, 1.0),
                         (2 * CHURN * d + c * d) * 4 + CHURN * 12, 6 * CHURN * c,
                         4 * CHURN * c * d))

    # kernel 5: one sweep over a training-sample-sized block
    n = Xt.shape[0]
    gC, gcnt, gdist = lloyd_sweep(Xt, Cb)
    wC, wcnt, wdist = ref.lloyd_sweep_ref(Xt, Cb)
    again = lloyd_sweep(Xt, Cb)
    assert all(torch.equal(a, b) for a, b in zip(again, (gC, gcnt, gdist))), \
        "lloyd_sweep is not bitwise reproducible"
    same = gcnt == wcnt
    moved = float((gcnt - wcnt).abs().sum())   # rows that changed centroid, x2
    rel = abs(float(gdist) - float(wdist)) / abs(float(wdist))
    assert moved <= 2 * 0.001 * n, f"lloyd counts differ by {moved}"
    assert torch.allclose(gC[same], wC[same], rtol=1e-5, atol=1e-6), "lloyd centroids"
    assert rel <= 1e-5, f"lloyd distortion rel err {rel}"
    ai, am = lloyd_mod.assign_phase(Xt, Cb)
    assign_agree = float((ai == ref.vq_assign_ref(Xt, Cb)[0]).float().mean())
    assert assign_agree >= 0.999, f"lloyd assignment agrees on {assign_agree} < 0.999"
    # the router's sweeps: its k-means over the c centroids, S supers
    Xr, Sr = idx.centroids.contiguous(), rt.super_centroids.contiguous()
    rcnt, wrcnt = lloyd_sweep(Xr, Sr)[1], ref.lloyd_sweep_ref(Xr, Sr)[1]
    r_moved = float((rcnt - wrcnt).abs().sum())
    assert r_moved <= 2 * 0.001 * Xr.shape[0] + 2, f"router-shape counts differ by {r_moved}"
    by_shape = {k: {"launches": v} for k, v in lloyd_shapes.items()}
    for X_, C_ in ((Xt, Cb), (Xr, Sr)):
        by_shape.setdefault(f"{X_.shape[0]}x{C_.shape[0]}x{X_.shape[1]}",
                            {"launches": 0})["ms"] = device_ms(lambda: lloyd_sweep(X_, C_),
                                                               busy)
    record("lloyd_sweep", "src/repro_torch/csrc/lloyd.cu",
           "src/repro/kernels/lloyd.py:158",
           float((gC[same] - wC[same]).abs().max()),
           time_ms(lambda: lloyd_sweep(Xt, Cb)),
           time_ms(lambda: ref.lloyd_sweep_ref(Xt, Cb)),
           (n * d + 2 * c * d + c) * 4 + 4, n * d, 2 * n * c * d,
           tile_loop="src/repro_torch/csrc/assign_tc.cuh",
           assign_ms=device_ms(lambda: lloyd_mod.assign_phase(Xt, Cb), busy),
           group_ms=device_ms(lambda: lloyd_mod.group_phase(Xt, Cb, ai, am), busy),
           assign_index_agreement=assign_agree, by_shape=by_shape,
           router_shape_count_moves=r_moved,
           counts_equal_share=float(same.float().mean()),
           count_moves=moved, distortion_rel_err=rel, shape=[n, c, d])

    # kernel 6: the trained router's tables; ids checked on every query,
    # timed on one bq tile
    tr = rt.eff_t_route
    tables = (rt.super_centroids, rt.child_centroids, rt.children)
    gs, gi = tree_route(ds.Q, *tables, tr)
    ws, wi = ref.tree_route_ref(ds.Q, *tables, tr)
    rows = (gi == wi).all(dim=1)
    row_agree = float(rows.float().mean())
    assert row_agree >= 0.999, f"tree_route id rows agree on {row_agree} < 0.999"
    assert torch.equal(torch.isinf(gs[rows]), torch.isinf(ws[rows])), "tree_route masks"
    fin = torch.isfinite(ws[rows])
    assert torch.allclose(gs[rows][fin], ws[rows][fin], rtol=1e-4, atol=1e-4), "tree_route"
    assert torch.equal(tree_route(ds.Q, *tables, tr)[0], gs), \
        "tree_route is not bitwise repeatable"

    def route_times(Q_, tabs, t_):
        """(device ms, the parent kernel's device ms or None, the wrapper's
        host µs per call) of one route at these inputs."""
        S_, cm_ = tabs[2].shape
        w = t_ * cm_

        def parent_route():
            sc = torch.empty((Q_.shape[0], w), device=DEVICE)
            ii = torch.empty((Q_.shape[0], w), dtype=torch.int32, device=DEVICE)
            par.launch("tree_route_launch", Q_, *tabs, Q_.shape[0], S_, cm_, Q_.shape[1],
                       t_, sc, ii)
            return sc, ii

        if par is not None:
            assert torch.equal(parent_route()[1], ref.tree_route_ref(Q_, *tabs, t_)[1]), \
                "parent tree_route ids"
        return (device_ms(lambda: tree_route(Q_, *tabs, t_), busy, 50),
                device_ms(parent_route, busy, 50) if par else None,
                host_us(lambda: tree_route(Q_, *tabs, t_)))

    def route_bytes_ops(nq_, S_, cm_, d_, t_):
        return ((nq_ * d_ + S_ * d_ + S_ * cm_ * d_ + S_ * cm_) * 4 + nq_ * t_ * cm_ * 8,
                2 * nq_ * (S_ + t_ * cm_) * d_)

    # the second shape: c = 32,768 at the router's defaults
    S2, T2, CM2 = 181, 23, 256
    tabs2 = tree_tables(args.seed, S2, CM2, D, DEVICE)
    Q2 = ds.Q[BQ:2 * BQ]
    g2s, g2i = tree_route(Q2, *tabs2, T2)
    w2s, w2i = ref.tree_route_ref(Q2, *tabs2, T2)
    assert torch.equal(g2i, w2i), "tree_route ids at the c = 32,768 shape"
    fin2 = torch.isfinite(w2s)
    assert torch.equal(fin2, torch.isfinite(g2s)), "tree_route masks at c = 32,768"
    assert torch.allclose(g2s[fin2], w2s[fin2], rtol=1e-4, atol=1e-4), "tree_route c=32,768"
    ms2, par2, host2 = route_times(Q2, tabs2, T2)
    b2 = bound(*route_bytes_ops(BQ, S2, CM2, D, T2))
    S, cm = rt.n_super, rt.cmax
    ms1, par1, host1 = route_times(Qb, tables, tr)
    record("tree_route", "src/repro_torch/csrc/tree_route.cu",
           "src/repro/kernels/tree_route.py:96", float((gs[rows][fin] - ws[rows][fin]).abs().max()),
           ms1, time_ms(lambda: ref.tree_route_ref(Qb, *tables, tr)),
           *route_bytes_ops(BQ, S, cm, D, tr), id_rows_equal_share=row_agree,
           shape=[BQ, S, cm, D, tr], parent_ms=par1, host_us=host1,
           router_call_host_us=host_us(lambda: rt.route(Qb, TOP_T)),
           back_to_back_ms=time_ms(lambda: tree_route(Qb, *tables, tr)),
           c32k={"shape": [BQ, S2, CM2, D, T2], "ms": ms2, "parent_ms": par2,
                 "host_us": host2, "bound_ms": b2[0], "bound_by": b2[1],
                 "share": b2[0] / ms2,
                 "max_abs_err": float((g2s[fin2] - w2s[fin2]).abs().max())})

    # the build's plain-torch work at its shapes: one shard for the spill
    # columns, the training sample for the anisotropic steps, all rows for
    # int8
    plain = []

    def plain_row(name, where, calls, ms, nbytes, ops_, shape, **extra):
        b_ms, b_by = bound(nbytes, ops_)
        plain.append({"name": name, "source": where, "calls": calls, "ms": ms,
                      "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / ms,
                      "shape": shape, **extra})

    n, c, d = Xs.shape[0], Cb.shape[0], Xs.shape[1]
    prim = ref.vq_assign_ref(Xs, Cb)[0]
    rh = unit_residuals(Xs, Cb, prim)
    first = torch.stack([prim, ref.soar_assign_ref(Xs, rh, prim, Cb, 1.0)[0]], 1)
    plain_row("spill_columns", "src/repro_torch/kernels/soar_assign.py",
              plain_calls["spill_columns"],
              time_ms(lambda: spill_columns(Xs, Cb, rh, first, 1.0, 1)),
              (2 * n * d + c * d) * 4 + 3 * n * 4, 6 * n * c * d + 12 * n * c, [n, c, d, 1])
    n = Xt.shape[0]
    eta = aniso_mod.eta_from_threshold(ANISO_T, d)
    plain_row("anisotropic_assign", "src/repro_torch/quant/anisotropic.py",
              plain_calls["anisotropic_assign"],
              time_ms(lambda: aniso_mod.anisotropic_assign(Xt, Cb, eta)),
              (n * d + c * d) * 4 + n * 4, 4 * n * c * d + 8 * n * c + 4 * n * d, [n, c, d])
    at = aniso_mod.anisotropic_assign(Xt, Cb, eta)
    A, bvec, _ = aniso_mod.normal_equations(Xt, at, eta, c)
    eye = torch.eye(d, device=DEVICE)
    plain_row("anisotropic_update", "src/repro_torch/quant/anisotropic.py",
              plain_calls["_anisotropic_update"],
              time_ms(lambda: aniso_mod._anisotropic_update(Xt, Cb, at, eta)),
              (n * d + n + 2 * c * d) * 4, 2 * n * d * d + n * d + c * (2 * d ** 3 // 3 + 2 * d * d),
              [n, c, d],
              accumulate_ms=time_ms(lambda: aniso_mod.normal_equations(Xt, at, eta, c)),
              solve_ms=time_ms(lambda: torch.linalg.solve(A + 1e-6 * eye, bvec[..., None])))
    n = N
    plain_row("int8_quantize", "src/repro_torch/quant/int8.py", plain_calls["int8_quantize"],
              time_ms(lambda: int8_quantize(ds.X)), n * d * 5 + n * 4, 5 * n * d, [n, d])
    for row in plain:
        print(f"plain {row['name']}: calls {row['calls']} ms {row['ms']:.4f} "
              f"bound {row['bound_ms']:.4f} ({row['bound_by']})")
    print("plain work: " + json.dumps(plain))

    # 15. result lines
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
