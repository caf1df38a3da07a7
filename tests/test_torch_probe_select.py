"""The probe scorer's selecting form (`pq_score_probes_select`) on the CPU,
without JAX: its plain version against the window scorer's plain version,
the id mask and `topk_first` over the whole window; the shape rule that
picks it over the window path; and the search through it against the
search through the window path, on both routers, filtered and under
`escalate="budget"`. The kernel itself is held against the plain version
in tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.core import pack_ivf, search_jit_batched
from repro_torch.core import search
from repro_torch.core.build import build_ivf_sharded
from repro_torch.core.router import FlatRouter, train_tree_router
from repro_torch.data.vectors import make_manifold
from repro_torch.kernels import ref
from repro_torch.kernels.pq_score import (SELECT_MAX, pq_score_probes_select,
                                          select_fits)
from repro_torch.utils import topk_first
from test_torch_cuda import select_case

N, D, C, M, NQ = 20_000, 32, 64, 8, 96
K, BUDGET = 10, 64


def window_top(luts, codes, extent, parts, psc, part_ids, keep, filter=None):
    """The selecting form's function written the long way: the whole
    window scored, each slot that is no candidate at -inf, a stable sort."""
    nq = parts.shape[0]
    w = ref.pq_score_probes_ref(luts, codes, extent, parts, psc)
    ids = part_ids[parts].reshape(nq, -1)
    ok = (ids >= 0) & torch.isfinite(w)
    if filter is not None:
        ok &= filter[ids.clamp(min=0)] > 0
    w = torch.where(ok, w, float("-inf"))
    v, pos = topk_first(w, min(keep, w.shape[1]))
    gi = torch.where(torch.isfinite(v), torch.gather(ids, 1, pos), -1).to(torch.int32)
    short = keep - v.shape[1]
    return (torch.nn.functional.pad(gi, (0, short), value=-1),
            torch.nn.functional.pad(v, (0, short), value=float("-inf")))


# (nq, t, c, pmax, m, keep): the cut inside a run of tied slots (row 0), a
# tombstone in every extent, a starved probe of a partition that holds
# rows (row 1); keep below, at and above the window's t·pmax slots
SELECT_CASES = [(3, 4, 6, 7, 5, 5), (8, 5, 10, 33, 16, 40), (4, 3, 5, 40, 50, 120),
                (5, 2, 4, 1, 16, 7), (6, 6, 12, 20, 5, 64), (2, 9, 30, 50, 7, SELECT_MAX)]


@pytest.mark.parametrize("filtered", [False, True], ids=["all", "filter"])
@pytest.mark.parametrize("nq,t,c,pmax,m,keep", SELECT_CASES)
def test_select_is_the_masked_windows_first_top_k(nq, t, c, pmax, m, keep, filtered):
    *args, filt = (torch.from_numpy(a) for a in select_case(nq, t, c, pmax, m))
    filt = filt if filtered else None
    got_i, got_v = pq_score_probes_select(*args, keep, filt)
    want_i, want_v = window_top(*args, keep, filt)
    assert got_i.shape == got_v.shape == (nq, keep) and got_i.dtype == torch.int32
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
    assert torch.equal(got_i >= 0, torch.isfinite(got_v))


def test_select_cut_takes_the_lowest_slots_of_a_tie():
    """Row 0's first two probes are one partition whose rows all hold one
    code, well above every other slot: a cut inside them keeps the lowest
    window slots, first probe first, tombstones skipped."""
    luts, codes, extent, parts, psc, part_ids, _ = (
        torch.from_numpy(a) for a in select_case(2, 4, 6, 7, 5))
    ids, vals = pq_score_probes_select(luts, codes, extent, parts, psc, part_ids, 6)
    row = part_ids[parts[0, 0]]
    live = row[row >= 0]
    assert torch.equal(ids[0], torch.cat([live, live])[:6])
    assert bool((vals[0] == vals[0, 0]).all())


def test_select_fits_is_the_window_paths_threshold():
    assert select_fits(1, 48) and select_fits(SELECT_MAX, 48) and SELECT_MAX >= 2 * 512 * 2
    assert not select_fits(SELECT_MAX + 1, 48) and not select_fits(0, 48)
    assert select_fits(512, 300) and not select_fits(512, 400)   # shared memory


# ------------------------------------------------------------- the search

@pytest.fixture(scope="module")
def data():
    ds = make_manifold(1, N, D, nq=NQ, device="cpu")
    return ds.X, ds.Q


@pytest.fixture(scope="module")
def packed(data):
    idx = build_ivf_sharded(torch.Generator().manual_seed(0), data[0], C, spill_mode="soar",
                            lam=1.0, pq_subspaces=M, device="cpu")
    return pack_ivf(idx), {"flat": FlatRouter(idx.centroids),
                           "tree": train_tree_router(torch.Generator().manual_seed(2),
                                                     idx.centroids)}


def _both_paths(monkeypatch, fn):
    """fn() through the selecting scorer, then through the window path."""
    sel = fn()
    with monkeypatch.context() as mp:
        mp.setattr(search, "select_fits", lambda keep, m: False)
        win = fn()
    return sel, win


def _same(sel, win):
    (si, sv), (wi, wv) = sel, win
    assert torch.equal(sv, wv)
    fin = torch.isfinite(wv)
    assert torch.equal(si[fin], wi[fin])
    assert bool((si[~fin] == -1).all())


@pytest.mark.parametrize("router", ["flat", "tree"])
@pytest.mark.parametrize("mode", ["plain", "filter", "escalate", "budget"])
def test_search_through_the_select_is_the_window_paths(monkeypatch, data, packed, router,
                                                       mode):
    pk, routers = packed
    Q = data[1]
    bits = None
    if mode != "plain":
        bits = np.zeros(N, np.uint8)
        bits[np.random.default_rng(3).choice(N, N // 50, replace=False)] = 1
    escalate = {"plain": False, "filter": False, "escalate": True,
                "budget": search.ESCALATE_BUDGET}[mode]
    sel, win = _both_paths(monkeypatch, lambda: search_jit_batched(
        pk, Q, 8, K, BUDGET, bq=32, filter=bits, escalate=escalate,
        router=routers[router]))
    _same(sel, win)
    assert int((sel[0] >= 0).sum()) > 0.9 * sel[0].numel()


def test_the_pass_takes_the_window_only_past_what_the_select_holds(data, packed):
    """keep = 2 · rerank_budget: 2,048 slots go through the selecting
    scorer (no "search.gather" stage), 2,050 through the window path."""
    pk, routers = packed
    Q = data[1][:8]
    assert 24 * pk.part_ids.shape[1] > 2050
    stages = {}
    for budget in (SELECT_MAX // 2, SELECT_MAX // 2 + 1):
        spans.reset()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            search_jit_batched(pk, Q, 24, K, budget, bq=8, router=routers["flat"])
        stages[budget] = {s.name for s in spans.spans()}
        spans.reset()
    assert "search.gather" not in stages[SELECT_MAX // 2]
    assert "search.gather" in stages[SELECT_MAX // 2 + 1]
