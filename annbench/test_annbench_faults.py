"""A run driven with the timed path or its index broken underneath comes
out not correct: one test a fault the cell can have (an answer altered
where it is produced; half of a batch left out; a step that leaves its
state unchanged, as a frozen Lloyd step or a spill left at the primary;
rows left unassigned; a PQ code, a router child or a child's centroid row
altered). Cells on one chip have no exchange between chips to leave out.
Each fault must fail the number `faults.CAUGHT_BY` names."""
from __future__ import annotations

import pytest

from annbench import faults, harness
from annbench.conftest import tiny

BATCH = ["glove100.batch", "deep10m.tree-batch"]
CASES = ([(w, f) for w in BATCH for f in ("answer_altered", "batch_halved")]
         + [(w, f) for w in BATCH + ["glove100.build"]
            for f in ("spill_at_primary", "rows_halved", "code_altered")]
         + [("deep10m.tree-batch", f) for f in ("router_child_dropped", "child_centroid_altered",
                                                 "router_children_swapped")]
         + [("glove100.build", f) for f in ("lloyd_frozen", "pq_frozen")])


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_caught(workload, fault):
    with faults.planted(fault):
        res = harness.run_cell(tiny(workload))
    assert not res["correct"], harness.check_lines(res)
    failed = {c.name for c in res["checks"] if not c.ok}
    assert faults.CAUGHT_BY[fault] in failed, harness.check_lines(res)


def test_every_fault_is_tested():
    assert {f for _, f in CASES} == set(faults.FAULTS)


def test_planted_fault_is_taken_out_again():
    from repro_torch.core import kmeans
    real = kmeans.lloyd_sweep
    with faults.planted("lloyd_frozen"):
        assert kmeans.lloyd_sweep is not real
    assert kmeans.lloyd_sweep is real
