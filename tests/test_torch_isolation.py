"""The port imports nothing of JAX and nothing of the JAX package.

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
                     "repro_torch.ckpt.wal"):
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
    """)
    assert r.returncode == 0, r.stderr
