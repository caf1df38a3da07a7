"""The port's serving CLI (`python -m repro_torch.launch.serve`) against
JAX's (`repro/launch/serve.py`), on the CPU.

- `main([... "--device", "cpu"])` prints JAX's two lines, and its ids
  equal `ServeEngine.generate` on the same parameters (`init_params`
  seeded 0) and prompts (`for_model(...).batch_at(0)`).
- With JAX's parameters carried over (`convert.model_params_from_numpy`)
  and the same numpy prompts, the CLI's ids equal JAX's `ServeEngine`
  (at f32 compute, as `test_torch_lm_serve.py` holds the engines).
- An encoder-only arch exits with JAX's message; `--device cuda` (the
  default) with no card raises before any work; `python -m` runs it.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import for_model  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--arch", "granite-3-2b", "--device", "cpu", "--batch", "2",
        "--prompt-len", "12", "--new", "6"]
LINE1 = re.compile(r"^arch=granite-3-2b-smoke generated \(2, 6\) in \d+\.\d\ds "
                   r"\(\d+\.\d tok/s, incl\. compile\)$")


def test_cli_prints_jax_lines_and_equals_the_engine(capsys):
    ids = serve.main(ARGS)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and LINE1.match(lines[0]), lines
    assert lines[1] == f"sample: {ids[0][:16].numpy()}"
    assert ids.shape == (2, 6) and ids.dtype == torch.int32
    cfg = get_config("granite-3-2b").smoke_config()
    params = TT.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    inputs = {k: v for k, v in for_model(cfg, seq_len=12, global_batch=2)
              .batch_at(0).items() if k != "labels"}
    want = ServeEngine(cfg, params, max_seq=12 + 6, device="cpu").generate(inputs, 6)
    assert torch.equal(ids, want)


def test_cli_ids_equal_jax_engine_on_carried_parameters(monkeypatch, capsys):
    jcfg = jconfigs.get_config("granite-3-2b").smoke_config().replace(
        compute_dtype="float32")
    tcfg = tconfig.ModelConfig(**dataclasses.asdict(jcfg))
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    carried = convert.model_params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    monkeypatch.setattr(serve, "get_config",
                        lambda arch: SimpleNamespace(smoke_config=lambda: tcfg))
    monkeypatch.setattr(serve.T, "init_params", lambda gen, cfg, device=None: carried)
    monkeypatch.setattr(serve, "for_model", lambda cfg, seq_len, global_batch: (
        SimpleNamespace(batch_at=lambda step: {"tokens": torch.from_numpy(tokens),
                                               "labels": None})))
    got = serve.main(ARGS)
    capsys.readouterr()
    want = JServeEngine(jcfg, jparams, max_seq=12 + 6).generate(
        {"tokens": jnp.asarray(tokens)}, 6)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_encoder_only_arch_exits_with_jax_message():
    with pytest.raises(SystemExit, match="^hubert-xlarge is encoder-only: no decode path$"):
        serve.main(["--arch", "hubert-xlarge", "--device", "cpu"])


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "granite-3-2b"])


def test_module_runs_as_a_script(tmp_path):
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", str(ROOT)), "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *ARGS],
                       cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert LINE1.match(lines[0]) and lines[1].startswith("sample: [")
