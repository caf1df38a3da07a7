"""No module of the benchmark imports JAX, its relatives or the JAX
package, by the whole top-level name (`repro_torch` is the program and
allowed; `repro` is not), and none reads the JAX package's benchmark folder."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

from annbench import harness

FILES = sorted(p for p in harness.BENCH.rglob("*.py") if "__pycache__" not in p.parts)
OLD_BENCH = "bench" + "marks"        # the JAX package's benchmark folder


def imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.BENCH)))
def test_no_jax_import(path):
    tops = {m.split(".")[0] for m in imported(path)}
    assert not tops & set(harness.FORBIDDEN), tops & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.BENCH)))
def test_does_not_read_the_jax_benchmarks(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert not any(part == OLD_BENCH for part in node.value.replace("\\", "/").split("/"))
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] + [getattr(node, "module", None) or ""]
            assert not any(n.split(".")[0] == OLD_BENCH for n in names)


def test_top_level_names_are_compared_whole():
    mods = {"repro_torch": 1, "repro_torch.core": 1, "jaxtyping": 1, "flaxen": 1}
    assert harness.forbidden_modules(mods) == []
    mods.update({"repro": 1, "repro.core.search": 1, "jax.numpy": 1, "jaxlib": 1, "flax": 1})
    assert harness.forbidden_modules(mods) == ["flax", "jax.numpy", "jaxlib", "repro",
                                               "repro.core.search"]


def test_this_process_runs_the_program_without_jax_imports_from_the_benchmark():
    """The benchmark's own imports pull in the program and nothing of JAX's
    (other test files of this process may have loaded JAX themselves)."""
    import subprocess
    import sys
    code = ("import sys; import annbench.harness, annbench.program as p; p.api(); "
            "from annbench.harness import forbidden_modules as f; print(f())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=120, env={"PATH": "/usr/bin:/bin",
                                                      "PYTHONPATH": str(harness.ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
