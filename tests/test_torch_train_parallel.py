"""The port's parallel training paths over torch.distributed (gloo) against
the JAX package and against its own single-process paths, on the CPU.

One JAX subprocess (8 virtual CPU devices, as tests/test_grad_compress.py
and tests/test_pipeline.py run theirs) computes `compressed_psum` and
three steps of `compressed_psum_with_feedback` on seeded numpy inputs, and
the two-stage pipelined loss of the granite smoke config (f32, no remat)
from PRNGKey(0). One group of 8 gloo ranks (processes, a file store in a
temporary directory, a time limit on every wait) then runs, with
subgroups:
- `compressed_all_reduce` (world 8) and its error-feedback loop: equal to
  JAX's bit for bit; JAX's bars over 30 steps (rel < 0.05, below naive);
- the two-stage pipeline by `group=` (ranks 0-1);
- expert parallelism at ep 2 and 4 (qwen3-moe smoke, f32): one MoE layer
  and the whole loss, outputs and gradients.
The main process holds them against the sequential loss and gradients
(JAX's bars: loss within 1e-5 relative, gradients rtol 2e-4 / atol 1e-6),
the pipeline by `devices=["cpu", "cpu"]`, JAX's pipelined loss on the
same parameters, and the dense MoE path (rtol 1e-5, atol 1e-6 of each
tensor's largest |value|: the sum across ranks adds in another order than
the dense slot order).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import grad_compress as jgc  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import model_params_from_numpy  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import params as prm  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import grad_compress as gc  # noqa: E402
from repro_torch.train.pipeline import (make_pipelined_loss,  # noqa: E402
                                        pipelined_loss_and_grad, stack_stage_params)

ROOT = Path(__file__).resolve().parents[1]
WORLD, N, EF_STEPS = 8, 4096, 30
M, MB, S = 4, 2, 16
T_SUB = 600
ENV = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
       "HOME": os.environ.get("HOME", str(ROOT)), "PYTHONPATH": str(ROOT / "src"),
       "JAX_PLATFORMS": "cpu", "GLOO_SOCKET_IFNAME": "lo", "OMP_NUM_THREADS": "1"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    workers on the machine's cores, and threads that wait on each other
    there cost more than they give."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.configs import get_config
from repro.launch.mesh import set_mesh
from repro.models import transformer as T
from repro.train.grad_compress import compressed_psum, compressed_psum_with_feedback
from repro.train.pipeline import make_pipelined_loss, stack_stage_params

inp = dict(np.load(sys.argv[1]))
mesh = jax.make_mesh((8,), ("data",))
f = shard_map(lambda xs: compressed_psum(xs[0], "data"), mesh=mesh,
              in_specs=P("data"), out_specs=P())
out = {"one_shot": np.asarray(f(inp["x"]))}

def body(gs, es):
    red, ne = compressed_psum_with_feedback(gs[0], es[0], "data")
    return red, ne[None]

f2 = shard_map(body, mesh=mesh, in_specs=(P("data"), P("data")),
               out_specs=(P(), P("data")))
err = np.zeros_like(inp["x"])
for i in range(3):
    red, err = f2(inp[f"g{i}"], err)
    out[f"ef_red{i}"], out[f"ef_err{i}"] = np.asarray(red), np.asarray(err)

cfg = get_config("granite-3-2b").smoke_config().replace(compute_dtype="float32",
                                                        remat="none")
params = T.init_params(jax.random.PRNGKey(0), cfg)
pm = jax.make_mesh((2,), ("pod",), devices=jax.devices()[:2])
with set_mesh(pm):
    fn = jax.jit(make_pipelined_loss(cfg, pm, n_stages=2))
    out["pipe_loss"] = np.asarray(fn(stack_stage_params(params, cfg, 2),
                                     inp["tokens"], inp["labels"]))
np.savez(sys.argv[2], **out)
print("OK")
"""

RANK_SCRIPT = r"""
import sys
from datetime import timedelta
import numpy as np, torch, torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.models import moe, params as prm, transformer as T
from repro_torch.train.grad_compress import (compressed_all_reduce,
                                             compressed_all_reduce_with_feedback)
from repro_torch.train.pipeline import (local_stage, pipelined_loss_and_grad,
                                        stack_stage_params)
rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                        world_size=world, timeout=timedelta(seconds=120))
inp = dict(np.load(f"{tmp}/inputs.npz"))
st = torch.load(f"{tmp}/state.pt")
out = {"one_shot": compressed_all_reduce(torch.from_numpy(inp["x"][rank]))}
err = torch.zeros(inp["x"].shape[1])
for i in range(3):
    red, err = compressed_all_reduce_with_feedback(torch.from_numpy(inp[f"g{i}"][rank]), err)
    out[f"ef_red{i}"], out[f"ef_err{i}"] = red, err
# JAX's error-feedback bars over 30 steps, naive beside it
err = torch.zeros(inp["x"].shape[1])
acc = {k: torch.zeros(inp["x"].shape[1]) for k in ("exact", "ef", "naive")}
for i in range(int(inp["ef_steps"])):
    g = torch.from_numpy(np.random.default_rng(100 + i).standard_normal(
        inp["x"].shape).astype(np.float32))
    red, err = compressed_all_reduce_with_feedback(g[rank], err)
    acc["exact"] += g.sum(0)
    acc["ef"] += red
    acc["naive"] += compressed_all_reduce(g[rank])
out["acc"] = acc
groups = {2: dist.new_group([0, 1]), 4: dist.new_group([0, 1, 2, 3])}
if rank < 2:                                      # the pipeline, a rank a stage
    cfg = get_config("granite-3-2b").smoke_config().replace(compute_dtype="float32",
                                                            remat="none")
    sp = local_stage(stack_stage_params(st["pipe_params"], cfg, 2), groups[2])
    out["pipe"] = pipelined_loss_and_grad(cfg, sp, torch.from_numpy(inp["tokens"]),
                                          torch.from_numpy(inp["labels"]), 2, group=groups[2])
cfg = get_config("qwen3-moe-30b-a3b").smoke_config().replace(compute_dtype="float32")
for ep, g in groups.items():
    if rank >= ep:
        continue
    layer = moe.local_experts({"groups": {"pos0_moe": st["moe_layer"]}}, cfg, g)
    p = prm.tree_map(lambda a: a[0].detach().requires_grad_(), layer["groups"]["pos0_moe"])
    x = st["moe_x"].clone().requires_grad_()
    y = moe.moe_mlp(p, x, cfg, ep_group=g)
    grads = torch.autograd.grad((y * st["moe_w"]).sum(), [x, p["router"], p["wi"], p["wo"]])
    local = prm.tree_map(lambda a: a.detach().requires_grad_(),
                         moe.local_experts(st["moe_params"], cfg, g))
    loss = T.loss_fn(local, st["moe_batch"], cfg, ep_group=g)
    paths, leaves = zip(*prm.leaf_paths(local))
    out[f"ep{ep}"] = {"y": y.detach(), "layer_grads": grads, "loss": loss.detach(),
                      "grads": dict(zip(paths, torch.autograd.grad(loss, leaves)))}
torch.save(out, f"{tmp}/rank{rank}.pt")
dist.destroy_process_group()
print("OK", rank)
"""


def _pipe_cfg(get=get_config):
    return get("granite-3-2b").smoke_config().replace(compute_dtype="float32", remat="none")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Inputs, JAX's results and the 8 gloo ranks' results (run once)."""
    tmp = tmp_path_factory.mktemp("train_parallel")
    rng = np.random.default_rng(0)
    inp = {"x": (rng.standard_normal((WORLD, N)) * 3.0).astype(np.float32),
           "tokens": rng.integers(0, 256, (M, MB, S)).astype(np.int32),
           "labels": rng.integers(0, 256, (M, MB, S)).astype(np.int32),
           "ef_steps": np.int64(EF_STEPS)}
    for i in range(3):
        inp[f"g{i}"] = rng.standard_normal((WORLD, N)).astype(np.float32)
    np.savez(tmp / "inputs.npz", **inp)
    jax_proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(tmp / "inputs.npz"),
                                 str(tmp / "jax.npz")], cwd=ROOT, env=ENV,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    jparams = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), _pipe_cfg(jget_config)))
    pipe_params = model_params_from_numpy(_pipe_cfg(), jparams, device="cpu").param_tree()
    cfg = get_config("qwen3-moe-30b-a3b").smoke_config().replace(compute_dtype="float32")
    moe_params = T.init_params(torch.Generator().manual_seed(4), cfg, device="cpu")
    g = torch.Generator().manual_seed(5)
    state = {"pipe_params": pipe_params, "moe_params": moe_params,
             "moe_layer": moe_params["groups"]["pos0_moe"],
             "moe_x": torch.randn((2, 24, cfg.d_model), generator=g),
             "moe_w": torch.randn((2, 24, cfg.d_model), generator=g),
             "moe_batch": {"tokens": torch.randint(0, cfg.vocab_size, (2, 24), generator=g,
                                                   dtype=torch.int32),
                           "labels": torch.randint(0, cfg.vocab_size, (2, 24), generator=g,
                                                   dtype=torch.int32)}}
    torch.save(state, tmp / "state.pt")
    procs = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, str(r), str(WORLD), str(tmp)],
                              cwd=ROOT, env=ENV, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=T_SUB) for p in procs + [jax_proc]]
    finally:
        for p in procs + [jax_proc]:
            p.kill()
    for p, (o, e) in zip(procs + [jax_proc], outs):
        assert p.returncode == 0 and "OK" in o, e[-4000:]
    return {"inputs": inp, "state": state, "jax": dict(np.load(tmp / "jax.npz")),
            "ranks": [torch.load(tmp / f"rank{r}.pt") for r in range(WORLD)]}


# ---------------------------------------------------- int8 gradient reduction

def test_compressed_all_reduce_equals_jax_bitwise(run):
    want = run["jax"]["one_shot"]
    exact = run["inputs"]["x"].sum(0)
    for r in range(WORLD):
        assert np.array_equal(run["ranks"][r]["one_shot"].numpy(), want), r
    rel = np.abs(want - exact).max() / np.abs(exact).max()
    assert rel < 0.05, rel                  # JAX's one-shot bar


@pytest.mark.parametrize("i", range(3))
def test_error_feedback_equals_jax_bitwise(run, i):
    """Step i of the loop: the reduced sum on every rank and each rank's
    residual equal JAX's bit for bit."""
    for r in range(WORLD):
        got = run["ranks"][r]
        assert np.array_equal(got[f"ef_red{i}"].numpy(), run["jax"][f"ef_red{i}"]), r
        assert np.array_equal(got[f"ef_err{i}"].numpy(), run["jax"][f"ef_err{i}"][r]), r


def test_error_feedback_bars(run):
    """JAX's bars (tests/test_grad_compress.py) over 30 steps: the
    accumulated error-feedback sum within 5% of the exact one, and closer
    than naive compression's."""
    acc = run["ranks"][0]["acc"]
    rel = float(torch.linalg.norm(acc["ef"] - acc["exact"]) / torch.linalg.norm(acc["exact"]))
    naive = float(torch.linalg.norm(acc["naive"] - acc["exact"]) / torch.linalg.norm(acc["exact"]))
    assert rel < 0.05 and rel < naive, (rel, naive)
    for r in range(1, WORLD):
        assert torch.equal(run["ranks"][r]["acc"]["ef"], acc["ef"])


def test_quantize_matches_jax_and_bounds():
    x = np.linspace(-5, 5, 100, dtype=np.float32)
    scale = np.float32(5 / 127.0)
    q = gc.quantize(torch.from_numpy(x), torch.tensor(scale))
    assert np.array_equal(q.numpy(), np.asarray(jgc.quantize(x, scale)))
    back = q.float() * scale
    assert float((back - torch.from_numpy(x)).abs().max()) <= float(scale) / 2 + 1e-6


# ------------------------------------------------------------------ pipeline

def _sequential(run):
    """Mean of the plain per-micro-batch losses and its gradients."""
    cfg = _pipe_cfg()
    params = prm.tree_map(lambda a: a.detach().requires_grad_(), run["state"]["pipe_params"])
    tok, lab = (torch.from_numpy(run["inputs"][k]) for k in ("tokens", "labels"))
    loss = sum(T.loss_fn(params, {"tokens": tok[i], "labels": lab[i]}, cfg)
               for i in range(M)) / M
    paths, leaves = zip(*prm.leaf_paths(params))
    return float(loss), dict(zip(paths, torch.autograd.grad(loss, leaves)))


@pytest.fixture(scope="module")
def sequential(run):
    return _sequential(run)


def _check_pipeline(loss, grads_of_stage, ref):
    """JAX's bars: loss within 1e-5 relative; the wq gradients of each
    stage's groups and stage 0's embed gradients rtol 2e-4 / atol 1e-6."""
    ref_loss, ref_grads = ref
    assert abs(float(loss) - ref_loss) / abs(ref_loss) < 1e-5, (float(loss), ref_loss)
    wq = ref_grads["['groups']['pos0_attn']['wq']"]
    per = wq.shape[0] // 2
    for s in range(2):
        g = grads_of_stage(s)
        np.testing.assert_allclose(g["groups"]["pos0_attn"]["wq"].numpy(),
                                   wq[s * per:(s + 1) * per].numpy(), rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(grads_of_stage(0)["embed"]["table"].numpy(),
                               ref_grads["['embed']['table']"].numpy(), rtol=2e-4, atol=1e-6)


def test_pipeline_by_devices_matches_sequential(run, sequential):
    cfg = _pipe_cfg()
    sp = stack_stage_params(run["state"]["pipe_params"], cfg, 2)
    tok, lab = (torch.from_numpy(run["inputs"][k]) for k in ("tokens", "labels"))
    loss, grads = pipelined_loss_and_grad(cfg, sp, tok, lab, 2, devices=["cpu", "cpu"])
    _check_pipeline(loss, lambda s: prm.tree_map(lambda a: a[s], grads), sequential)


def test_pipeline_by_group_matches_sequential(run, sequential):
    pipes = [run["ranks"][r]["pipe"] for r in range(2)]
    assert torch.equal(pipes[0][0], pipes[1][0])           # every stage holds the loss
    _check_pipeline(pipes[0][0], lambda s: prm.tree_map(lambda a: a[0], pipes[s][1]),
                    sequential)
    assert not pipes[1][1]["embed"]["table"].any()          # only stage 0 embeds


def test_pipeline_matches_jax_pipelined_loss(run):
    """The port's pipelined loss on JAX's parameters within 1e-5 relative
    of JAX's two-stage shard_map pipeline."""
    cfg = _pipe_cfg()
    tok, lab = (torch.from_numpy(run["inputs"][k]) for k in ("tokens", "labels"))
    with torch.no_grad():
        got = make_pipelined_loss(cfg, 2, devices=["cpu", "cpu"])(
            stack_stage_params(run["state"]["pipe_params"], cfg, 2), tok, lab)
    want = float(run["jax"]["pipe_loss"])
    assert abs(float(got) - want) / abs(want) < 1e-5, (float(got), want)


def test_pipeline_placement_is_one_of_devices_or_group():
    cfg = _pipe_cfg()
    with pytest.raises(ValueError, match="exactly one"):
        make_pipelined_loss(cfg, 2)
    with pytest.raises(ValueError, match="do not split"):
        stack_stage_params(T.abstract_params(cfg), cfg, 3)


# -------------------------------------------------------- expert parallelism

def _moe_cfg():
    return get_config("qwen3-moe-30b-a3b").smoke_config().replace(compute_dtype="float32")


def _close(a, b):
    """rtol 1e-5, atol 1e-6 of the tensor's largest |value| (the layer's
    outputs and gradients reach ~100, where one f32 ulp is ~1e-5)."""
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                               atol=1e-6 * max(1.0, float(b.abs().max())))


@pytest.mark.parametrize("ep", [2, 4])
def test_expert_parallel_layer_matches_dense(run, ep):
    """One MoE layer: each rank's output, its input and router gradients
    (summed across ranks) and its own experts' wi / wo gradients against
    the dense layer's."""
    cfg, st = _moe_cfg(), run["state"]
    p = prm.tree_map(lambda a: a[0].detach().requires_grad_(), st["moe_layer"])
    x = st["moe_x"].clone().requires_grad_()
    y = moe.moe_mlp(p, x, cfg)
    gx, grt, gwi, gwo = torch.autograd.grad((y * st["moe_w"]).sum(),
                                            [x, p["router"], p["wi"], p["wo"]])
    n = cfg.n_experts // ep
    for r in range(ep):
        got = run["ranks"][r][f"ep{ep}"]
        _close(got["y"], y.detach())
        _close(got["layer_grads"][0], gx)
        _close(got["layer_grads"][1], grt)
        _close(got["layer_grads"][2], gwi[r * n:(r + 1) * n])
        _close(got["layer_grads"][3], gwo[r * n:(r + 1) * n])


@pytest.mark.parametrize("ep", [2, 4])
def test_expert_parallel_loss_matches_dense(run, ep):
    """The whole model's loss and every gradient: replicated leaves whole,
    expert leaves as each rank's block."""
    cfg, st = _moe_cfg(), run["state"]
    params = prm.tree_map(lambda a: a.detach().requires_grad_(), st["moe_params"])
    loss = T.loss_fn(params, st["moe_batch"], cfg)
    paths, leaves = zip(*prm.leaf_paths(params))
    dense = dict(zip(paths, torch.autograd.grad(loss, leaves)))
    n = cfg.n_experts // ep
    for r in range(ep):
        got = run["ranks"][r][f"ep{ep}"]
        np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-5)
        assert set(got["grads"]) == set(dense)
        for path, g in got["grads"].items():
            want = dense[path]
            if path.endswith(("['wi']", "['wo']")) and "_moe" in path:
                want = want[:, r * n:(r + 1) * n]
            _close(g, want)


def test_local_experts_refuses_an_uneven_split(monkeypatch):
    monkeypatch.setattr(moe.dist, "get_world_size", lambda g: 4)
    monkeypatch.setattr(moe.dist, "get_rank", lambda g: 0)
    with pytest.raises(ValueError, match="do not split"):
        moe.local_experts({"groups": {}}, _moe_cfg().replace(n_experts=6), object())
