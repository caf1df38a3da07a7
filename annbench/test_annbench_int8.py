"""The int8 cell's pieces at a tiny size on the CPU: its references
(`reference/int8.py`, `reference/spills.py`), its driver
(`drivers/batch_int8.py`) against the program, planted faults and a
program that serves f32 rows, and its three readers."""
from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from annbench import compare, harness, program, spans
from annbench.conftest import tiny
from annbench.reference import int8 as ri
from annbench.reference import spills as rs

CELL = "glove100-soar2-int8.batch"
READERS = ["int8_rerank_roofline.int8", "rerank_bytes_per_query.int8", "idle_pct.int8"]


def small(seed: int = 2**31 + 11, trace: bool = False, d: int = 20):
    """The cell at n 3,000, d 20 (or d), c 16, m 10, two spills, T 0.2."""
    ctx = tiny(CELL, seed=seed, trace=trace)
    ctx.cfg["data"] = dict(ctx.cfg["data"], d=d)
    ctx.cfg["index"] = dict(ctx.cfg["index"], n_partitions=16, pq_subspaces=10)
    return ctx


@pytest.fixture(scope="module")
def served():
    ctx = small()
    res = harness.run_cell(ctx)
    return ctx, res


def nums(res) -> dict:
    return {c.name: c.value for c in res["checks"]}


def failing(res) -> set:
    return {c.name for c in res["checks"] if not c.ok}


def test_the_program_serves_the_reference_rows(served):
    ctx, res = served
    got, lim = nums(res), compare.limits(ctx.bench_dir, CELL)
    assert res["correct"], harness.check_lines(res)
    assert got["miss_share"] == 0 and got["int8_bad"] == 0 and got["slot_bad"] == 0
    assert got["score_err"] <= 1e-5 and got["spill_gap"] <= lim["spill_gap"]
    assert got["rerank_bytes_a_row"] == 20 + 4
    table = ctx.state["engine"].index.rerank
    assert table.q.dtype == torch.int8 and table.scale.dtype == torch.float32


def test_the_quantization_rule_is_the_programs_bits():
    X = torch.randn(5000, 20)
    X[0] = 0.0                                            # a zero row
    X[1] = torch.tensor([0.5, -0.5] * 10) * 127 / 63.5    # halves after the scale
    want = ri.quantize(X)
    program.api()
    from repro_torch.quant.int8 import int8_quantize
    got = int8_quantize(X)
    assert torch.equal(got.q, want.q) and torch.equal(got.scale, want.scale)
    assert ri.bad_rows(got.q, got.scale, want) == 0
    s = want.scale.clone()
    s[7] = torch.nextafter(s[7], torch.tensor(1.0))
    assert ri.bad_rows(want.q, s, want) == 1


def test_the_three_columns_are_the_programs():
    program.api()
    from repro_torch.core.soar import soar_assign_multi
    g = torch.Generator().manual_seed(0)
    X = torch.nn.functional.normalize(torch.randn(4000, 20, generator=g), dim=1)
    C = X[torch.randperm(4000, generator=g)[:32]] + 0.01
    cols = rs.choices(X, C, 1.0, 2)
    prog = soar_assign_multi(X, C, cols[:, 0].to(torch.int32), lam=1.0, n_spills=2)
    for j in range(3):
        assert float((prog[:, j].long() == cols[:, j]).float().mean()) >= 0.999
    ag, sg = rs.gaps(X, C, cols, 1.0)
    assert ag <= 1e-6 and sg <= 1e-6
    perm = cols[:, [2, 0, 1]]                             # any order of the set reads alike
    assert rs.gaps(X, C, perm, 1.0) == (ag, sg)
    wrong = cols.clone()
    wrong[:, 2] = (cols[:, 2] + 1) % 32
    keep = ~(wrong[:, 2:3] == cols[:, :2]).any(1)
    assert rs.gaps(X[keep], C, wrong[keep], 1.0)[1] > 1e-3


def test_a_scale_off_by_one_ulp_fails_int8_bad(served):
    ctx, _ = served
    drv = harness.driver(ctx)
    table = ctx.state["engine"].index.rerank
    old = table.scale[5].clone()
    table.scale[5] = torch.nextafter(old, torch.tensor(1.0))
    try:
        got = drv.numbers(ctx)
    finally:
        table.scale[5] = old
    assert got["int8_bad"] == 1


def test_a_swapped_third_column_fails_spill_gap(monkeypatch):
    """Row 0's third column swapped for the partition farthest from it."""
    program.api()
    import repro_torch.kernels.soar_assign as sa
    real = sa.spill_columns

    def swapped(X, C, rhat, assigned, lam, n_more, *a, **kw):
        out = real(X, C, rhat, assigned, lam, n_more, *a, **kw)
        d = ((X[:1] - C) ** 2).sum(1)
        out[0, -1] = int(d.argmax())
        return out
    monkeypatch.setattr(sa, "spill_columns", swapped)
    res = harness.run_cell(small(seed=99))
    assert "spill_gap" in failing(res), harness.check_lines(res)


def test_a_program_serving_f32_rows_fails_rerank_bytes_alone(monkeypatch):
    """The parent's serving: int8 rows dequantized into an f32 table at
    wrap time. Every row is the plain rows dequantized, bit for bit, so
    only the table's 4d bytes a row fail (at the configuration's d, 100,
    which the limit d + 4 is set for)."""
    program.api()
    from repro_torch.core.mutable import MutableIVF
    from repro_torch.quant.int8 import int8_dequantize
    real = MutableIVF.from_index.__func__

    def f32_table(cls, idx, *a, **kw):
        m = real(cls, idx, *a, **kw)
        m.rerank = int8_dequantize(m.rerank)
        return m
    monkeypatch.setattr(MutableIVF, "from_index", classmethod(f32_table))
    res = harness.run_cell(small(seed=5, d=100))
    assert failing(res) == {"rerank_bytes_a_row"}, harness.check_lines(res)
    assert nums(res)["rerank_bytes_a_row"] == 4 * 100 and nums(res)["int8_bad"] == 0


def test_least_work_by_hand():
    mod = harness.load(harness.BENCH / "metrics" / "int8_rerank_roofline.int8.py")
    w = mod.least_work(nq=3, budget=5, d=8, k=2)
    # 15 candidates of 8 + 4 + 4 bytes; queries 3·8·4; outputs 3·2·8
    assert w.nbytes == 15 * 16 + 96 + 48 and w.ops == 2 * 15 * 8 and w.mm_ops == 0


def test_the_readers_on_a_synthetic_reading(monkeypatch):
    placed = [spans.Placed("engine.search_request", 0.0, 1.0, 1, 0, 1, {"queries": 10}),
              spans.Placed("search.rerank", 0.2, 0.3, 2, 1, 1,
                           {"rows": 2000, "row_bytes": 2000 * 104}),
              spans.Placed("engine.search_request", 1.0, 2.0, 3, 0, 3, {"queries": 10}),
              spans.Placed("search.rerank", 1.2, 1.3, 4, 3, 3,
                           {"rows": 1000, "row_bytes": 1000 * 104})]
    monkeypatch.setattr(spans, "reading", lambda _c: spans.Reading(placed, {}, 0.0, [], 0.0))
    mod = harness.load(harness.BENCH / "metrics" / "rerank_bytes_per_query.int8.py")
    assert mod.read(SimpleNamespace()) == pytest.approx(3000 * 104 / 20)
    monkeypatch.setattr(spans, "reading", lambda _c: None)
    assert mod.read(SimpleNamespace()) is None


def test_a_traced_tiny_cell_reads_row_bytes_per_query():
    """The CPU's traced run: `row_bytes` per query is the valid candidates'
    d + 4 bytes, at most the budget's; no device kernel, so no roofline."""
    res = harness.run_cell(small(trace=True))
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(got) == {"rerank_bytes_per_query.int8", "idle_pct.int8"}
    budget = tiny(CELL).cfg["engine"]["rerank_budget"]
    assert 10 * 24 <= got["rerank_bytes_per_query.int8"] <= budget * 24
    assert 0 <= got["idle_pct.int8"] <= 100


@pytest.mark.parametrize("name", READERS)
def test_every_reader_is_found_with_its_unit(name):
    mod = harness.load(harness.BENCH / "metrics" / f"{name}.py")
    m = harness.find(harness.manifest()["per_layer"], name)
    assert (mod.UNIT, mod.SOURCE) == (m["unit"], m["source"]) and m["workloads"] == [CELL]
