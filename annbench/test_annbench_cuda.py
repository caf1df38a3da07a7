"""On the card (skips without one): each cell at a tiny size is correct
through the kernels, and its control is not."""
from __future__ import annotations

import pytest

from annbench import harness
from annbench.conftest import tiny

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_and_control_on_the_card(cuda, workload):
    assert harness.run_cell(tiny(workload, device=cuda))["correct"]
    assert not harness.run_cell(tiny(workload, device=cuda), control=True)["correct"]
