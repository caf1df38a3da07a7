"""The PyTorch examples (`examples/torch/*.py`) beside the JAX ones, on the
CPU without running them (they run on the card, in chip_smoke.py):

- each ports the JAX example of its name and keeps its sizes: every
  number written in the JAX script's code appears in the port's (but a
  PRNG key count);
- each has `main(argv)` and a `--device cuda|cpu` flag whose default is
  the card: with no card, `main([])` raises before doing any work.

`test_torch_isolation.py` imports each with JAX and the JAX package
blocked.
"""
import ast
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
NAMES = ["quickstart", "ann_serving", "knn_memory_decode", "train_lm"]
# numbers of a JAX example that are no size: jax.random.split(key, 3)'s key count
NOT_SIZES = {"knn_memory_decode": {3}}


def _numbers(path: Path) -> set:
    """Every int or float literal of a script's code (docstrings aside)."""
    return {n.value for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, ast.Constant) and type(n.value) in (int, float)}


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", ROOT / "examples" / "torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_jax_example_has_a_port():
    assert sorted(p.stem for p in (ROOT / "examples").glob("*.py")) == sorted(NAMES)
    assert sorted(p.stem for p in (ROOT / "examples" / "torch").glob("*.py")) == sorted(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_example_keeps_the_jax_sizes(name):
    jax_numbers = _numbers(ROOT / "examples" / f"{name}.py") - NOT_SIZES.get(name, set())
    port_numbers = _numbers(ROOT / "examples" / "torch" / f"{name}.py")
    assert jax_numbers <= port_numbers, jax_numbers - port_numbers


@pytest.mark.parametrize("name", NAMES)
def test_example_runs_on_the_card_by_default(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main([])
