#!/usr/bin/env python3
"""Drive the PyTorch port of SOAR (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits nonzero; nothing is caught):
  1. device: nvidia-smi's name and power limit, torch's device name;
  2. build: nvcc builds the CUDA kernels from src/repro_torch/csrc;
  3. main path at GloVe-100-angular's shape (ann-benchmarks
     glove-100-angular: 1,183,514 x 100, 10k queries; here n=1,000,000,
     d=100, nq=10,000 from make_manifold(seed)) with ScaNN's published
     ann-benchmarks config for that set (num_leaves=2000, dims_per_block=2,
     so 50 PQ subspaces): build_ivf_sharded (SOAR lam=1, f32 rerank) ->
     pack_ivf -> search_jit_batched (top_t=40, final_k=10,
     rerank_budget=256, bq=128). Kernel launch counters are zeroed just
     before and read just after. Checks recall@10 >= 0.85 against exact
     search, every kernel launched, and ids agreeing on >= 99% of slots
     with the same search through the plain window scorer;
  4. each kernel against its plain PyTorch version on the main path's own
     inputs, with its time (CUDA events), the plain version's time and the
     least time the card could take (larger of bytes / 3.35 TB/s and
     operations / 67 TFLOP/s f32, the H100 SXM's published peaks);
  5. the {"kernels": [...]} line, then the device line, last.

It imports nothing of JAX and nothing of the JAX package (src/repro).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N, D, NQ = 1_000_000, 100, 10_000
C, M = 2000, 50
TOP_T, FINAL_K, BUDGET, BQ = 40, 10, 256, 128
TRAIN_SAMPLE, SHARD = 131_072, 65_536
PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12


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


def bound(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextmanager
def plain_window_scorer():
    """Run the search with the window kernel's plain version in its place."""
    from repro_torch.core import search
    from repro_torch.kernels.ref import pq_score_window_ref
    saved = search.window_pq_scores
    search.window_pq_scores = pq_score_window_ref
    try:
        yield
    finally:
        search.window_pq_scores = saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from repro_torch.core import (build_ivf_sharded, pack_ivf, recall_at_k,
                                  search_jit_batched, true_neighbors)
    from repro_torch.core.router import FlatRouter
    from repro_torch.data.vectors import make_manifold
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.lloyd import lloyd_sweep
    from repro_torch.kernels.pq_score import pq_score_window
    from repro_torch.kernels.soar_assign import soar_assign
    from repro_torch.kernels.vq_assign import vq_assign
    from repro_torch.quant.pq import pq_lut
    from repro_torch.utils import set_f32_precision

    set_f32_precision()
    wrappers = {"pq_score_window": pq_score_window, "vq_assign": vq_assign,
                "soar_assign": soar_assign, "lloyd_sweep": lloyd_sweep}

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
          f"count {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    lib = _build.library_path()
    _build.library()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s")

    # 3. main path
    t0 = time.perf_counter()
    ds = make_manifold(args.seed, N, D, nq=NQ, device="cuda")
    sync()
    print(f"data: {N} x {D}, {NQ} queries in {time.perf_counter() - t0:.2f} s")

    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    phases: dict = {}
    t0 = time.perf_counter()
    idx = build_ivf_sharded(torch.Generator().manual_seed(args.seed), ds.X, C,
                            spill_mode="soar", lam=1.0, pq_subspaces=M,
                            rerank="f32", train_sample=TRAIN_SAMPLE,
                            shard_size=SHARD, timings=phases, device="cuda")
    sync()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    packed = pack_ivf(idx)
    sync()
    pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    search_jit_batched(packed, ds.Q, top_t=TOP_T, final_k=FINAL_K,
                       rerank_budget=BUDGET, bq=BQ)
    sync()
    first_search_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ids, _ = search_jit_batched(packed, ds.Q, top_t=TOP_T, final_k=FINAL_K,
                                rerank_budget=BUDGET, bq=BQ)
    sync()
    search_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    peak_mem = torch.cuda.max_memory_allocated()

    pmax = int(packed.part_ids.shape[1])
    sizes = idx.partition_sizes().float()
    gt = true_neighbors(ds.X, ds.Q, k=FINAL_K, chunk=65_536)
    recall = recall_at_k(ids, gt, FINAL_K)
    with plain_window_scorer():
        plain_ids, _ = search_jit_batched(packed, ds.Q, top_t=TOP_T,
                                          final_k=FINAL_K, rerank_budget=BUDGET,
                                          bq=BQ)
    agree = float((plain_ids == ids).float().mean())
    summary = {
        "n": N, "d": D, "nq": NQ, "c": C, "m": M, "top_t": TOP_T,
        "rerank_budget": BUDGET, "bq": BQ, "build_s": build_s,
        "build_phases_s": phases, "pack_s": pack_s,
        "first_search_s": first_search_s, "search_s": search_s,
        "qps": NQ / search_s, "recall_at_10": recall,
        "ids_agree_plain_scorer": agree,
        "max_memory_allocated_bytes": peak_mem,
        "n_assignments": idx.n_assignments, "pmax": pmax,
        "mean_partition": float(sizes.mean()), "window": TOP_T * pmax,
        "launches": launches,
    }
    print("main path: " + json.dumps(summary))
    assert recall >= 0.85, f"recall@10 {recall} < 0.85"
    assert all(v > 0 for v in launches.values()), f"a kernel never ran: {launches}"
    assert agree >= 0.99, f"ids agree with the plain scorer on {agree} < 0.99"

    # 4. each kernel against its plain version, on the main path's inputs
    kernels = []

    def record(name, source, replaces, err, ms, plain_ms, nbytes, ops, **extra):
        b_ms, b_by = bound(nbytes, ops)
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                        **extra})
        print(f"kernel {name}: err {err:.3g} ms {ms:.4f} plain {plain_ms:.4f} "
              f"bound {b_ms:.4f} ({b_by}) {extra}")

    # kernel 2: one bq tile of the real window
    Qb = ds.Q[:BQ]
    luts = pq_lut(packed.pq, Qb).contiguous()
    _, parts = FlatRouter(packed.centroids).route(Qb, TOP_T)
    codes = packed.part_codes[parts].reshape(BQ, TOP_T * pmax, M).contiguous()
    got, want = pq_score_window(luts, codes), ref.pq_score_window_ref(luts, codes)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5), "pq_score_window"
    record("pq_score_window", "src/repro_torch/csrc/pq_score_window.cu",
           "src/repro/kernels/pq_score.py:116",
           float((got - want).abs().max()),
           time_ms(lambda: pq_score_window(luts, codes)),
           time_ms(lambda: ref.pq_score_window_ref(luts, codes), 3),
           codes.numel() + luts.numel() * 4 + got.numel() * 4,
           codes.numel(), shape=list(codes.shape))

    # kernels 3 and 4: one assignment shard against the trained codebook
    Xs, Cb = ds.X[:SHARD].contiguous(), idx.centroids.contiguous()
    n, c, d = Xs.shape[0], Cb.shape[0], Xs.shape[1]
    gi, gv = vq_assign(Xs, Cb)
    wi, wv = ref.vq_assign_ref(Xs, Cb)
    vq_agree = float((gi == wi).float().mean())
    assert vq_agree >= 0.999 and torch.allclose(gv, wv, rtol=1e-4, atol=1e-4), "vq_assign"
    record("vq_assign", "src/repro_torch/csrc/vq_assign.cu",
           "src/repro/kernels/vq_assign.py:56", float((gv - wv).abs().max()),
           time_ms(lambda: vq_assign(Xs, Cb)),
           time_ms(lambda: ref.vq_assign_ref(Xs, Cb)),
           (n * d + c * d) * 4 + n * 8, 2 * n * c * d,
           index_agreement=vq_agree, shape=[n, c, d])

    r = Xs - Cb[wi.long()]
    rhat = (r / torch.linalg.vector_norm(r, dim=-1, keepdim=True).clamp(min=1e-12)).contiguous()
    gi, gv = soar_assign(Xs, rhat, wi, Cb, 1.0)
    si, sv = ref.soar_assign_ref(Xs, rhat, wi, Cb, 1.0)
    soar_agree = float((gi == si).float().mean())
    assert soar_agree >= 0.999 and torch.allclose(gv, sv, rtol=1e-4, atol=1e-4), "soar_assign"
    assert not bool((gi == wi).any()), "soar_assign returned a primary"
    record("soar_assign", "src/repro_torch/csrc/soar_assign.cu",
           "src/repro/kernels/soar_assign.py:63", float((gv - sv).abs().max()),
           time_ms(lambda: soar_assign(Xs, rhat, wi, Cb, 1.0)),
           time_ms(lambda: ref.soar_assign_ref(Xs, rhat, wi, Cb, 1.0)),
           (2 * n * d + c * d) * 4 + n * 12, 4 * n * c * d + 6 * n * c,
           index_agreement=soar_agree, shape=[n, c, d])

    # kernel 5: one sweep over a training-sample-sized block
    Xt = ds.X[:TRAIN_SAMPLE].contiguous()
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
    record("lloyd_sweep", "src/repro_torch/csrc/lloyd.cu",
           "src/repro/kernels/lloyd.py:158",
           float((gC[same] - wC[same]).abs().max()),
           time_ms(lambda: lloyd_sweep(Xt, Cb)),
           time_ms(lambda: ref.lloyd_sweep_ref(Xt, Cb)),
           (n * d + 2 * c * d + c) * 4 + 4, 2 * n * c * d + n * d,
           counts_equal_share=float(same.float().mean()),
           count_moves=moved, distortion_rel_err=rel, shape=[n, c, d])

    # 5. result lines
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
