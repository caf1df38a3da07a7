"""Fixtures of the benchmark's own tests: cells cut to a size the CPU runs
in a second, through the program's plain (CPU) paths."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from annbench import harness  # noqa: E402

TINY = {"n": 3000, "d": 16, "nq": 64, "intrinsic_dim": 6, "hidden": 32, "manifold_seed": 1}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (and nvcc); skips without one")


def tiny(workload: str, seed: int = 2**31 + 11, seconds: float = 0.3, trace: bool = False,
         device: str = "cpu", root: Path = ROOT) -> harness.Ctx:
    """A cell of the manifest at `root`, its configuration cut to TINY."""
    ctx = harness.Ctx(harness.manifest(root), workload, seed, seconds, trace, device,
                      bench_dir=root / "annbench")
    cfg = dict(ctx.cfg, data=dict(TINY))
    cfg["index"] = dict(cfg["index"], n_partitions=24, pq_subspaces=8, train_sample=2048,
                        shard_size=1024)
    if cfg["index"].get("router") == "tree":
        cfg["index"]["router_kw"] = {"n_super": 5, "t_route": 3}
    cfg["engine"] = dict(cfg["engine"], top_t=6, rerank_budget=48, bq=16)
    cfg["search"] = dict(cfg["search"], check_sample=48)
    ctx.cfg = cfg
    return ctx


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test process: the suite runs under several
    workers, each with a few tiny cells."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"
