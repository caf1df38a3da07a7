"""Each driver at a tiny size on the CPU, through its functions: a run of
the program comes out correct with every number at its limit, and the
control (the reference at TF32 in the program's place) comes out not
correct."""
from __future__ import annotations

import numpy as np
import pytest

from annbench import harness
from annbench.conftest import tiny

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_program_is_correct(workload):
    res = harness.run_cell(tiny(workload))
    assert res["correct"], harness.check_lines(res)
    e2e = {m["name"] for m in harness.end_to_end(harness.manifest(), workload)}
    assert set(res["metrics"]) == e2e
    assert all(np.isfinite(m["value"]) and m["value"] > 0 for m in res["metrics"].values())
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    res = harness.run_cell(tiny(workload, seed=7), control=True)
    assert not res["correct"], harness.check_lines(res)


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reads_its_metrics_and_breakdown(workload):
    res = harness.run_cell(tiny(workload, trace=True))
    assert res["correct"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0
    line = harness.result_line(res)
    assert list(__import__("json").loads(line))[-1] == "checks"
