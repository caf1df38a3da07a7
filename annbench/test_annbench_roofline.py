"""Each count of least work against a case worked by hand."""
from __future__ import annotations

import pytest
import torch

from annbench import roofline as R


def test_extents():
    pid = torch.tensor([[3, -1, 5, -1], [-1, -1, -1, -1], [0, 1, 2, 7]], dtype=torch.int32)
    assert R.extents(pid).tolist() == [3, 0, 4]


def test_probe_scoring_by_hand():
    ext = torch.tensor([10, 20, 30])
    parts = torch.tensor([[0, 1], [1, 2]])           # 2 queries, 2 probes each
    w = R.probe_scoring(ext, parts, m=4)
    # LUTs 2·4·16·4 = 512; probes 4·8 = 32; extents of {0,1,2} 3·4 = 12;
    # codes (10+20+30)·4 = 240; scores written (10+20 + 20+30)·4 = 320
    assert w.nbytes == 512 + 32 + 12 + 240 + 320
    assert w.ops == 80 * 4 and w.mm_ops == 0


def test_flat_route_by_hand():
    w = R.flat_route(nq=3, c=5, d=2, t=2)
    assert w.nbytes == (3 + 5) * 2 * 4 + 3 * 2 * 8
    assert w.mm_ops == 2 * 3 * 5 * 2


def test_tree_route_by_hand():
    children = torch.tensor([[0, 1, -1], [2, -1, -1], [3, 4, 5]], dtype=torch.int32)
    sup = torch.tensor([[0, 2], [2, 1]])             # 2 queries, t_route 2
    w = R.tree_route(sup, children, nq=2, S=3, d=4)
    # Q and supers (2+3)·4·4 = 80; distinct supers {0,1,2}: 6 children ·(16+4) = 120;
    # per query 2+3 and 3+1 = 9 children, 8 bytes each = 72
    assert w.nbytes == 80 + 120 + 72
    assert w.mm_ops == 2 * 4 * (2 * 3 + 9)


def test_search_pass_by_hand():
    ext = torch.tensor([4, 6])
    parts = torch.tensor([[0], [1], [1]])
    route = R.Work(100.0, 0.0, 10.0)
    w = R.search_pass(nq=3, d=4, c=2, m=2, k=1, budget=2, route=route, ext=ext,
                      parts=parts, n_rerank_rows=5)
    # queries + centroids (3+2)·4·4 = 80; PQ codebook 2·16·2·4 = 256; extents 2·4 = 8;
    # codes and ids (4+6)·(2+4) = 60; rerank rows 5·4·4 = 80; outputs 3·1·8 = 24
    assert w.nbytes == 100 + 80 + 256 + 8 + 60 + 80 + 24
    assert w.ops == (4 + 6 + 6) * 2
    assert w.mm_ops == 10 + 2 * 3 * (2 * 16 * 2 + 2 * 4)


def test_lloyd_and_soar_by_hand():
    w = R.lloyd_sweep(n=10, c=3, d=2)
    assert (w.nbytes, w.ops, w.mm_ops) == ((10 + 6) * 2 * 4 + 12, 20.0, 120.0)
    s = R.soar_assign(n=10, c=3, d=2)
    assert (s.nbytes, s.mm_ops) == (2 * 10 * 2 * 4 + 40 + 24 + 80, 240.0)


def test_seconds_and_share():
    w = R.Work(R.PEAK_BYTES_S * 1e-3, ops=R.PEAK_F32_S * 0.5e-3)
    assert w.seconds() == pytest.approx(1e-3)        # bytes bound it
    w2 = R.Work(0.0, mm_ops=R.PEAK_TF32_S * 1e-3)
    assert w2.seconds() == pytest.approx(3e-3)       # 3×TF32
    assert R.share_pct(w, 2e-3) == pytest.approx(50.0)
    assert R.share_pct(w, 0.0) is None
