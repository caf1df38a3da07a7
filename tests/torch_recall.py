"""Recall of free builds compared across two random streams.

A free build draws its codebook from its package's own stream (JAX's
`PRNGKey`, the port's `torch.Generator`), or on two devices whose float
paths differ, so one build on each side is one draw from each of two
distributions: at n = 20,000 a build's recall@10 spreads about 0.02
across seeds, and one draw against one draw differs by more than 0.02
about one time in twenty even when the two means agree. A test that
compares recall across streams therefore compares the mean over the
first four seeds on each side, at the bar it would give a single draw.
The seeds are fixed: never search for seeds that pass.

Each side is a function of the seed that builds, searches and returns
recall@10 (the port's side also asserts its structural checks there, so
they hold on every draw), or the values already computed for SEEDS (a
reference built in a subprocess). Nothing here imports JAX, so the card's
tests use it too.
"""
from typing import Callable, Sequence, Union

import torch

SEEDS = (0, 1, 2, 3)
BAR = 0.02

Side = Union[Callable[[int], float], Sequence[float]]


def _draws(side: Side) -> list:
    if not callable(side):
        vals = [float(v) for v in side]
    else:
        # one torch thread: the test runner's workers share the CPU, and a
        # build's eight OpenMP threads, oversubscribed, ran 5-20x slower
        # than one (the recall does not depend on the thread count)
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            vals = [float(side(s)) for s in SEEDS]
        finally:
            torch.set_num_threads(n)
    assert len(vals) == len(SEEDS), f"{len(vals)} recalls for {len(SEEDS)} seeds"
    return vals


def assert_recall_means_close(port: Side, ref: Side) -> None:
    """|mean(port) − mean(ref)| ≤ BAR over SEEDS."""
    got, want = _draws(port), _draws(ref)
    gap = sum(got) / len(got) - sum(want) / len(want)
    assert abs(gap) <= BAR, f"mean recall gap {gap:+.4f} > {BAR}: port {got}, reference {want}"
