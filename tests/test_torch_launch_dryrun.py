"""The port's dry run (`repro_torch.launch.ann_dryrun`) and its op-counting
analysis (`repro_torch.launch.op_analysis`) against JAX's
(`repro.launch.ann_dryrun`, `repro.launch.hlo_analysis`), on the CPU.

- The analysis on `test_hlo_analysis.py`'s programs, written once in each
  package from one numpy seed: product FLOPs equal JAX's within JAX's own
  tolerances (rel 1e-6 for one product, 0.05 for loops) and the hand
  count exactly; a loop's bytes are at least its reads of w. Also a
  fake-group all-gather's output bytes, the temp high-water mark of a
  known sequence of allocations and frees, and the byte rules (views and
  allocations move nothing, a gather reads what it gathers).
- The probe scorer on meta tensors: its output's shape, and the bytes of
  chip_smoke.py's bound for the kernel at the shard-parallel shape (row
  "m25"), reported once and with no plain-version op.
- The whole slice: JAX's `ann_dryrun.run` for both meshes and both
  variants in a subprocess (`cwd` a temporary directory, JAX on the CPU)
  against the port's `run` on meta tensors: collective count and bytes
  and product FLOPs equal exactly; argument bytes equal once the arrays
  that differ are named by their bytes (the port's `extent`, 2,500 int32
  = 10,000 B, and `sizes`, 10,000 B, which JAX's `jit` drops because its
  search never reads it). Temp and HBM bytes are printed beside JAX's and
  not held: the port's are eager and unfused. The PQ single-mesh cell is
  also held to the committed `artifacts/dryrun/ann_serve_pq_single.json`.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro.launch.hlo_analysis import analyze as jax_analyze  # noqa: E402
from repro_torch.core.distributed import (abstract_sharded_ivf,  # noqa: E402
                                          abstract_sharded_ivf_pq)
from repro_torch.analysis.contracts import OpRecorder  # noqa: E402
from repro_torch.core.search import PackedIVF, search_jit_batched  # noqa: E402
from repro_torch.kernels.pq_score import pq_score_probes, pq_score_probes_select  # noqa: E402
from repro_torch.quant.pq import PQCodebook  # noqa: E402
from repro_torch.launch import ann_dryrun  # noqa: E402
from repro_torch.launch.dryrun import fmt_summary  # noqa: E402
from repro_torch.launch.op_analysis import OpCounter, analyze  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ENV = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
       "HOME": os.environ.get("HOME", str(ROOT)), "PYTHONPATH": str(ROOT / "src"),
       "JAX_PLATFORMS": "cpu"}
CELLS = [(mp, pq) for mp in (False, True) for pq in (False, True)]
# arrays that differ between the two per-device programs, by their bytes
PORT_ONLY = {"extent": 2_500 * 4}      # the PQ stack's slot extent
JAX_PRUNED = {"sizes": 2_500 * 4}      # unused by JAX's search; its jit drops it
Q_BYTES = ann_dryrun.NQ * ann_dryrun.D * 4


def _cell_id(cell):
    mp, pq = cell
    return f"{'multi' if mp else 'single'}-{'pq' if pq else 'baseline'}"


def _jax_text(f, *arrays):
    return jax.jit(f).lower(*(jax.ShapeDtypeStruct(a.shape, jnp.float32)
                              for a in arrays)).compile().as_text()


def _arrays(*shapes):
    rng = np.random.default_rng(0)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# ------------------------------------------------- test_hlo_analysis.py's programs

def test_single_matmul_flops_match_jax():
    a, b = _arrays((64, 32), (32, 16))
    want = jax_analyze(_jax_text(lambda x, y: x @ y, a, b))["flops"]
    got = analyze(lambda x, y: x @ y, torch.from_numpy(a), torch.from_numpy(b))
    assert got["flops"] == 2 * 64 * 32 * 16
    assert got["flops"] == pytest.approx(want, rel=1e-6)
    assert got["flops_by_dtype"] == {"float32": 2 * 64 * 32 * 16}


@pytest.mark.parametrize("iters", [1, 5, 23])
def test_loop_flops_scale_with_the_trip_count(iters):
    (x,) = _arrays((128, 128))

    def jf(c):
        out, _ = jax.lax.scan(lambda c, _: (c @ c, None), c, jnp.arange(iters))
        return out

    def tf(c):
        for _ in range(iters):
            c = c @ c
        return c

    want = jax_analyze(_jax_text(jf, x))["flops"]
    got = analyze(tf, torch.from_numpy(x))["flops"]
    assert got == 2 * 128 ** 3 * iters
    assert got == pytest.approx(want, rel=0.05)


def test_nested_loop_multiplier():
    (x,) = _arrays((64, 64))

    def jf(c):
        def outer(c, _):
            c2, _ = jax.lax.scan(lambda c, _: (c @ c, None), c, jnp.arange(3))
            return c2, None
        out, _ = jax.lax.scan(outer, c, jnp.arange(4))
        return out

    def tf(c):
        for _ in range(4):
            for _ in range(3):
                c = c @ c
        return c

    want = jax_analyze(_jax_text(jf, x))["flops"]
    got = analyze(tf, torch.from_numpy(x))["flops"]
    assert got == 2 * 64 ** 3 * 3 * 4
    assert got == pytest.approx(want, rel=0.05)


def test_hbm_bytes_scale_with_loop():
    x, w = _arrays((256, 256), (256, 256))

    def jf(c, w):
        out, _ = jax.lax.scan(lambda c, _: (jnp.tanh(c @ w), None), c, jnp.arange(10))
        return out

    def tf(c, w):
        for _ in range(10):
            c = torch.tanh(c @ w)
        return c

    want = jax_analyze(_jax_text(jf, x, w))["hbm_bytes"]
    got = analyze(tf, torch.from_numpy(x), torch.from_numpy(w))["hbm_bytes"]
    # each iteration must re-read w (256*256*4 = 262144 B) → ≥ 10×
    assert want >= 10 * 262144 and got >= 10 * 262144
    print(f"tanh loop bytes: port {got:.0f} (eager), JAX {want:.0f} (fused)")


# ------------------------------------------------------------- the port's own rules

def test_all_gather_on_a_fake_group_counts_its_output_bytes():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        def fn(t):
            parts = [torch.empty_like(t) for _ in range(8)]
            dist.all_gather(parts, t)
            return torch.cat(parts)
        r = analyze(fn, torch.empty((4, 10), device="meta"))
    finally:
        dist.destroy_process_group()
    assert r["collectives"]["all-gather"] == {"count": 1.0, "bytes": 8 * 4 * 10 * 4}
    assert r["collective_bytes_total"] == 8 * 160
    assert r["out"].shape == (32, 10)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_temp_is_the_high_water_mark_of_live_storages(device):
    def fn(x):
        a = x.new_empty(1000)           # 4,000 B live
        b = x.new_empty(2000)           # 12,000
        v = b[:5]                       # a view: no storage
        del a                           # 8,000
        c = x.new_empty(2500)           # 18,000: the high water
        del b, c, v                     # 0
        d = x.new_empty(3000)           # 12,000
        return d[:10]

    r = analyze(fn, torch.zeros(100_000, device=device))
    assert r["temp_bytes"] == 18_000
    assert r["argument_bytes"] == 400_000 and r["output_bytes"] == 40


def test_views_and_allocations_move_nothing_and_a_gather_reads_what_it_gathers():
    x, y = torch.ones(1000), torch.ones(1000)
    assert analyze(lambda a, b: a + b, x, y)["hbm_bytes"] == 3 * 4000
    assert analyze(lambda a: a.view(10, 100)[:, :5].t(), x)["hbm_bytes"] == 0
    assert analyze(lambda a: torch.empty_like(a), x)["hbm_bytes"] == 0
    src, idx = torch.ones((1000, 8)), torch.arange(10)
    r = analyze(lambda s, i: s[i], src, idx, top_n=2)
    assert r["hbm_bytes"] == 320 + 80 + 320        # gathered rows, ids, output
    assert r["top_hbm"][0]["op"] == "index" and r["top_hbm"][0]["calls"] == 1


# ------------------------------------------------------------- the probe scorer on meta

def test_probe_scorer_on_meta_reports_the_kernels_bytes_only():
    nq, t, c, pmax, m = 64, 40, 2_500, 1_000, 25        # chip_smoke's row "m25"

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    args = (meta((nq, m, 16), torch.float32), meta((c, pmax, m), torch.uint8),
            meta((c,), torch.int32), meta((nq, t), torch.int64),
            meta((nq, t), torch.float32))
    before = pq_score_probes.launches
    with OpCounter() as counter:
        out = pq_score_probes(*args)
    counter.close()
    assert out.shape == (nq, t * pmax) and out.dtype == torch.float32
    assert out.device.type == "meta"
    # chip_smoke.py's probe_bytes: probed code rows (pmax a probe on meta),
    # LUTs, int64 probes, coarse scores, one int32 extent a probe, the f32
    # output
    luts, _, _, parts, psc = args
    want = (nq * t * pmax * m + luts.numel() * 4 + parts.numel() * 8
            + psc.numel() * 4 + parts.numel() * 4 + out.numel() * 4)
    assert counter.kernels == {"pq_score_probes": {"calls": 1, "bytes": want,
                                                   "flops": 0.0}}
    assert counter.hbm_bytes == want and counter.flops == 0
    assert counter.n_ops == 1           # its output's allocation, nothing else
    assert pq_score_probes.launches == before


def test_probe_select_on_meta_reports_its_bytes_and_writes_no_window():
    nq, t, c, pmax, m, keep = 64, 40, 2_500, 1_000, 25, 512

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    args = (meta((nq, m, 16), torch.float32), meta((c, pmax, m), torch.uint8),
            meta((c,), torch.int32), meta((nq, t), torch.int64),
            meta((nq, t), torch.float32), meta((c, pmax), torch.int32))
    bits = meta((5_000_000,), torch.uint8)
    before = pq_score_probes_select.launches
    with OpRecorder() as rec, OpCounter() as counter:
        ids, vals = pq_score_probes_select(*args, keep, bits)
    counter.close()
    assert ids.shape == vals.shape == (nq, keep) and ids.device.type == "meta"
    assert (ids.dtype, vals.dtype) == (torch.int32, torch.float32)
    # the probed code rows (pmax a probe on meta), LUTs, int64 probes,
    # coarse scores, one int32 extent a probe; then a kept slot's id and
    # filter byte read, its id and score written
    want = (nq * t * pmax * m + nq * m * 16 * 4 + nq * t * (8 + 4 + 4)
            + nq * keep * (4 + 1 + 4 + 4))
    assert counter.kernels == {"pq_score_probes_select": {"calls": 1, "bytes": want,
                                                          "flops": 0.0}}
    # its two outputs and the blocks' survivors (4 probes a block, so 2,560
    # probes make 640 blocks), no window
    assert sorted(o.shape for o in rec.outputs) == [(nq, keep), (nq, keep),
                                                    (nq, t // 4 * keep)]
    assert pq_score_probes_select.launches == before


@pytest.mark.parametrize("budget,window", [(1024, False), (1025, True)])
def test_pq_search_on_meta_allocates_a_window_only_past_the_select(budget, window):
    """A PQ search on meta tensors: at keep = 2 · 1,024 slots the pass
    makes no (nq, t·pmax) tensor and launches the selecting scorer; at
    2 · 1,025, past what it holds on chip, it takes the window path."""
    nq, c, pmax, m, d, n, top_t = 64, 300, 401, 8, 32, 60_000, 12

    def meta(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    ext = meta((c,), torch.int32)
    packed = PackedIVF(meta((c, d)), meta((c, pmax), torch.int32),
                       meta((c, pmax, m), torch.uint8), ext, ext,
                       PQCodebook(meta((m, 16, d // m))), meta((n, d)))
    with OpRecorder() as rec, OpCounter() as counter:
        ids, vals = search_jit_batched(packed, meta((nq, d)), top_t, 10, budget, bq=nq,
                                       filter=meta((n,), torch.uint8), escalate=False)
    counter.close()
    assert ids.shape == vals.shape == (nq, 10)
    wide = [o for o in rec.outputs if top_t * pmax in o.shape]
    assert bool(wide) == window
    assert set(counter.kernels) == ({"pq_score_probes"} if window
                                    else {"pq_score_probes_select"})


def test_probe_scorer_refuses_meta_mixed_with_cpu():
    luts = torch.zeros((2, 4, 16))
    rest = (torch.empty((3, 8, 4), dtype=torch.uint8, device="meta"),
            torch.empty(3, dtype=torch.int32, device="meta"),
            torch.empty((2, 2), dtype=torch.int64, device="meta"),
            torch.empty((2, 2), device="meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        pq_score_probes(luts, *rest)


# ------------------------------------------------------------- the slice against JAX

JAX_RUN = textwrap.dedent("""
    import json
    import numpy as np
    from repro.core.distributed import abstract_sharded_ivf, abstract_sharded_ivf_pq
    from repro.launch import ann_dryrun as a

    seen = []
    orig = a.analyze
    a.analyze = lambda text, **kw: seen.append(orig(text, **kw)) or seen[-1]
    out = []
    for mp in (False, True):
        for pq in (False, True):
            r = a.run(mp, pq=pq)
            n = r["n_chips"]
            ivf = (abstract_sharded_ivf_pq(n, a.N_LOCAL, a.C_LOCAL, a.PMAX, a.D, a.D // 4)
                   if pq else abstract_sharded_ivf(n, a.N_LOCAL, a.C_LOCAL, a.PMAX, a.D))
            fields = {f: int(np.prod(x.shape)) * x.dtype.itemsize // n
                      for f, x in zip(ivf._fields, ivf)}
            out.append({"result": r, "flops": seen[-1]["flops"],
                        "hbm_bytes": seen[-1]["hbm_bytes"], "fields": fields,
                        "line": a.fmt_summary(r)})
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_cells(tmp_path_factory):
    """JAX's dry run of the four cells, in a subprocess that writes only
    under a temporary directory."""
    cwd = tmp_path_factory.mktemp("jax_dryrun")
    r = subprocess.run([sys.executable, "-c", JAX_RUN], cwd=cwd, env=ENV,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(zip(CELLS, json.loads(r.stdout.strip().splitlines()[-1])))


@pytest.fixture(scope="module")
def port_cells(tmp_path_factory):
    cwd = tmp_path_factory.mktemp("port_dryrun")
    here = os.getcwd()
    os.chdir(cwd)
    try:
        out = {cell: ann_dryrun.run(cell[0], pq=cell[1]) for cell in CELLS}
    finally:
        os.chdir(here)
    out["files"] = sorted(os.listdir(cwd / "artifacts" / "dryrun_torch"))
    return out


def _port_fields(pq: bool) -> dict:
    a = ann_dryrun
    ivf = (abstract_sharded_ivf_pq(1, a.N_LOCAL, a.C_LOCAL, a.PMAX, a.D, a.D // 4)
           if pq else abstract_sharded_ivf(1, a.N_LOCAL, a.C_LOCAL, a.PMAX, a.D))
    return {f: x.numel() * x.element_size() for f, x in zip(ivf._fields, ivf)}


@pytest.mark.parametrize("cell", CELLS, ids=_cell_id)
def test_dry_run_counts_equal_jax(cell, jax_cells, port_cells):
    mp, pq = cell
    j, got = jax_cells[cell], port_cells[cell]
    want = j["result"]
    assert got["n_chips"] == want["n_chips"] == (512 if mp else 256)
    assert got["shape"] == want["shape"] and got["mesh"] == want["mesh"]
    # collectives: two all-gathers of the (D, nq, k) ids and scores
    assert got["collectives"] == want["collectives"]
    assert got["collectives"]["all-gather"]["bytes"] == 2 * want["n_chips"] * 1024 * 10 * 4
    assert got["collective_bytes_total"] == want["collective_bytes_total"]
    # product FLOPs: route, LUTs and rerank (PQ); route and the f32 window
    assert got["per_device"]["flops"] == j["flops"]
    assert j["flops"] == (567_705_600 if pq else 8_704_000_000)
    # argument bytes, with the arrays that differ named by their bytes
    port_fields, jax_fields = _port_fields(pq), j["fields"]
    assert set(port_fields) - set(jax_fields) == ({"extent"} if pq else set())
    assert {f: port_fields[f] for f in jax_fields} == jax_fields
    assert port_fields["sizes"] == JAX_PRUNED["sizes"]
    assert not pq or port_fields["extent"] == PORT_ONLY["extent"]
    only = PORT_ONLY["extent"] if pq else 0
    assert got["memory"]["argument_bytes"] == sum(port_fields.values()) + Q_BYTES
    assert want["memory"]["argument_bytes"] == (sum(jax_fields.values()) + Q_BYTES
                                                - JAX_PRUNED["sizes"])
    assert got["memory"]["argument_bytes"] - only - JAX_PRUNED["sizes"] == \
        want["memory"]["argument_bytes"]
    assert got["memory"]["output_bytes"] == 1024 * 10 * 8
    assert got["memory"]["peak_bytes"] == (got["memory"]["argument_bytes"]
                                           + got["memory"]["temp_bytes"])
    assert set(want) <= set(got) and set(want["roofline"]) <= set(got["roofline"])
    print(f"{_cell_id(cell)}: temp {got['memory']['temp_bytes']} (JAX "
          f"{want['memory']['temp_bytes']}), hbm {got['per_device']['hbm_bytes']:.0f} "
          f"(JAX {j['hbm_bytes']:.0f})")


@pytest.mark.parametrize("cell", CELLS, ids=_cell_id)
def test_fmt_summary_prints_jax_line(cell, jax_cells):
    assert fmt_summary(jax_cells[cell]["result"]) == jax_cells[cell]["line"]


def test_dry_run_writes_its_own_artifacts(port_cells):
    assert port_cells["files"] == ["ann_serve_multi.json", "ann_serve_pq_multi.json",
                                   "ann_serve_pq_single.json", "ann_serve_single.json"]


def test_pq_single_matches_the_committed_jax_artifact(port_cells):
    with open(ROOT / "artifacts" / "dryrun" / "ann_serve_pq_single.json") as f:
        want = json.load(f)
    got = port_cells[(False, True)]
    assert got["collectives"] == want["collectives"]
    assert got["collective_bytes_total"] == want["collective_bytes_total"] == 20_971_520
    assert got["memory"]["argument_bytes"] - PORT_ONLY["extent"] - JAX_PRUNED["sizes"] \
        == want["memory"]["argument_bytes"] == 473_916_004
    # the file keeps compute_s, at JAX's 197e12 FLOP/s, to six digits
    assert float(f"{got['per_device']['flops'] / 197e12:.6g}") == \
        want["roofline"]["compute_s"]
    # the search's PQ pass launches the selecting scorer, one a 64-query tile
    kernels = got["per_device"]["kernels"]
    assert kernels["pq_score_probes_select"]["calls"] == 1024 // 64
    assert "pq_score_probes" not in kernels


def test_roofline_terms_are_the_h100s(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    got = ann_dryrun.run(False, pq=True, world=4)       # inside one node: NVLink
    rf = got["roofline"]
    assert got["n_chips"] == 4 and rf["collective_bw"] == 450e9
    assert rf["compute_s"] == float(f"{567_705_600 / 67e12:.6g}")
    assert rf["memory_s"] == float(f"{got['per_device']['hbm_bytes'] / 3.35e12:.6g}")
    assert rf["collective_s"] == float(f"{2 * 4 * 1024 * 10 * 4 / 450e9:.6g}")
    assert rf["bound_step_s"] == pytest.approx(rf[rf["dominant"]], rel=1e-5)
    assert rf[rf["dominant"]] == max(rf["compute_s"], rf["memory_s"], rf["collective_s"])
    assert os.listdir(tmp_path / "artifacts" / "dryrun_torch") == \
        ["ann_serve_pq_single_world4.json"]


def test_run_refuses_beside_a_default_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already exists"):
            ann_dryrun.run(False, pq=True)
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()


def test_run_names_a_missing_fake_backend(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.testing._internal.distributed.fake_pg", None)
    with pytest.raises(RuntimeError, match="fake_pg"):
        ann_dryrun.run(False, pq=True)
    assert not dist.is_initialized()
