"""The port's training CLI (`python -m repro_torch.launch.train`) and the
trainer's preemption path, on the CPU, each in its own interpreter (a
SIGTERM must reach the main thread of a process of its own).

- `--device cpu --steps 3` writes checkpoints; a second call with
  `--steps 5` resumes from step 3 and runs only steps 3 and 4.
- `train()` whose `on_log` sends SIGTERM to its own process after step 2
  saves and leaves the loop; a fresh `train()` resumes from its
  CheckpointManager to step 4, and the parameters and AdamW state equal
  an uninterrupted 4-step run's bit for bit.
- Asked for CUDA where there is no card, the CLI fails and trains nothing.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import train as launch_train  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ENV = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
       "HOME": os.environ.get("HOME", str(ROOT)), "PYTHONPATH": str(ROOT / "src"),
       "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
T_SUB = 300


def _run(args, cwd):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=ENV, capture_output=True,
                          text=True, timeout=T_SUB)


def test_cli_writes_checkpoints_and_resumes(tmp_path):
    ck = tmp_path / "ck"
    base = ["-m", "repro_torch.launch.train", "--device", "cpu", "--ckpt-dir", str(ck),
            "--ckpt-every", "2"]
    r = _run(base + ["--steps", "3"], tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    runs = sorted(os.listdir(ck / "granite-3-2b-smoke"))
    assert runs == ["ckpt_00000001", "ckpt_00000003"], runs
    assert "step     0 loss" in r.stdout and "step     2 loss" in r.stdout
    r = _run(base + ["--steps", "5"], tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "[train] resumed from step 3" in r.stdout
    assert "step     0 loss" not in r.stdout and "step     4 loss" in r.stdout
    assert "ckpt_00000005" in os.listdir(ck / "granite-3-2b-smoke")


PREEMPT = r"""
import os, signal, sys
import torch
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import for_model
from repro_torch.models import params as prm
from repro_torch.train.train_loop import train

cfg = get_config("granite-3-2b").smoke_config()
pipe = for_model(cfg, seq_len=32, global_batch=4)
kw = dict(steps=4, lr=1e-3, log_every=1, seed=3, device="cpu")
p_ref, s_ref, _ = train(cfg, pipe, **kw)

def kill_after_2(step, metrics):
    if step == 2:
        os.kill(os.getpid(), signal.SIGTERM)

mgr = CheckpointManager(sys.argv[1], keep=1)
_, _, first = train(cfg, pipe, ckpt_manager=mgr, ckpt_every=100, on_log=kill_after_2, **kw)
assert len(first) == 3 and mgr.steps() == [3], (first, mgr.steps())
p, s, rest = train(cfg, pipe, ckpt_manager=CheckpointManager(sys.argv[1], keep=1),
                   ckpt_every=100, **kw)
assert len(rest) == 1
for a, b in zip((p, s.m, s.v), (p_ref, s_ref.m, s_ref.v)):
    for (pa, ta), (pb, tb) in zip(prm.leaf_paths(a), prm.leaf_paths(b)):
        assert pa == pb and torch.equal(ta, tb), pa
assert int(s.step) == int(s_ref.step) == 4
print("OK")
"""


def test_sigterm_saves_and_a_fresh_train_resumes_bitwise(tmp_path):
    r = _run(["-c", PREEMPT, str(tmp_path / "ck")], tmp_path)
    assert r.returncode == 0 and "OK" in r.stdout, (r.stdout[-2000:], r.stderr[-3000:])
    assert "[train] preemption signal → saved at step 2, exiting" in r.stdout
    assert "[train] resumed from step 3" in r.stdout


def test_cli_asked_for_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--device", "cuda", "--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert not any(p.name.startswith("ckpt_") for p in tmp_path.rglob("*"))
