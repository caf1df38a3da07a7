"""The port, its examples (`examples/torch/`) and `chip_smoke.py` import
nothing of JAX and nothing of the JAX package.

Each check runs in a fresh interpreter whose `sys.modules` maps `jax`,
`jaxlib` and `repro` to None, so any import of them — at module level or
lazily, at import time — raises there.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

BLOCK = textwrap.dedent("""
    import sys
    for name in ("jax", "jaxlib", "repro"):
        sys.modules[name] = None
""")


def _run(body: str) -> subprocess.CompletedProcess:
    env = {"PATH": os.environ.get("PATH", ""), "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu", "HOME": os.environ.get("HOME", str(ROOT))}
    return subprocess.run([sys.executable, "-c", BLOCK + textwrap.dedent(body)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)


def test_every_port_module_imports_without_jax():
    pytest.importorskip("torch")
    r = _run("""
        import importlib, pkgutil
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                       "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        for name in ("repro_torch.core.mutable", "repro_torch.serve.engine",
                     "repro_torch.serve.api", "repro_torch.convert",
                     "repro_torch.kernels._build", "repro_torch.core.kmr",
                     "repro_torch.core.analysis", "repro_torch.faults",
                     "repro_torch.ckpt.faults", "repro_torch.ckpt.index_store",
                     "repro_torch.ckpt.wal", "repro_torch.serve.frontend",
                     "repro_torch.serve.health", "repro_torch.serve.knn_memory",
                     "repro_torch.core.distributed", "repro_torch.models.config",
                     "repro_torch.models.params", "repro_torch.models.layers",
                     "repro_torch.models.attention", "repro_torch.models.moe",
                     "repro_torch.models.ssm", "repro_torch.models.transformer",
                     "repro_torch.configs", "repro_torch.configs.granite_3_2b",
                     "repro_torch.configs.xlstm_350m",
                     "repro_torch.configs.qwen3_moe_30b_a3b",
                     "repro_torch.collectives", "repro_torch.train.optimizer",
                     "repro_torch.train.train_loop", "repro_torch.train.grad_compress",
                     "repro_torch.train.pipeline", "repro_torch.data.pipeline",
                     "repro_torch.ckpt.checkpoint", "repro_torch.launch.train",
                     "repro_torch.launch.serve", "repro_torch.launch.ann_dryrun",
                     "repro_torch.launch.dryrun", "repro_torch.launch.op_analysis",
                     "repro_torch.launch.mesh", "repro_torch.launch.specs",
                     "repro_torch.launch.profile_cell", "repro_torch.spans"):
            assert name in names, (name, names)
        assert not any(k == "jax" or k.startswith(("jax.", "repro."))
                       for k, v in sys.modules.items() if v is not None)
    """)
    assert r.returncode == 0, r.stderr


def test_chip_smoke_imports_without_jax():
    pytest.importorskip("torch")
    r = _run("""
        import importlib.util
        spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.main)
        import repro_torch.core, repro_torch.serve   # what main() imports
        import repro_torch.configs, repro_torch.models.transformer
    """)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("name", ["quickstart", "ann_serving", "knn_memory_decode",
                                  "train_lm"])
def test_torch_example_imports_without_jax(name):
    pytest.importorskip("torch")
    r = _run(f"""
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "example", "examples/torch/{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.main)
        assert not any(k == "jax" or k.startswith(("jax.", "repro."))
                       for k, v in sys.modules.items() if v is not None)
    """)
    assert r.returncode == 0, r.stderr
