"""The port's logical sharding (`launch/mesh.py`, `models/params.pspecs`,
`transformer.param_pspecs` / `cache_pspecs`, `layers.shard`, the MoE
layer's `local_map` branch) against the JAX package's, on the CPU.

One JAX subprocess (512 virtual CPU devices, `JAX_PLATFORMS=cpu`, its
meshes built with `AxisType.Auto`: jax 0.9's default `Explicit` axes make
`with_sharding_constraint` assert) computes
- every config's parameter and cache specs with each leaf's
  `NamedSharding(mesh, spec).shard_shape` on the (16, 16) and (2, 16, 16)
  meshes, for every shape cell (decode under `serve_rules`);
- the SPMD train step of tests/test_distributed.py (granite's smoke
  config, mesh (2, 4), `rules["heads"] = None`, accum 2, 3 steps, seq 32,
  batch 8) sharded and on one device, at f32 and at the config's bf16.
The port's side of the table runs on a "fake" process group of 256 / 512
ranks with meta tensors. One group of 8 gloo ranks (processes, a file
store in a temporary directory) runs the port's steps from JAX's
parameters and batches, and prefill + 4 decode steps of granite,
xlstm-350m and qwen3-moe-30b-a3b (smoke, f32) sharded over (2, 4) under
JAX's dry-run rules (`serve_rules` for decode), each held against the
unsharded port on each data rank's rows: the MoE capacity is a data
rank's (JAX's shard_map computes it from the local tokens too).

Bars: f32 train within 1e-5 of the unsharded port (only the order of the
reductions differs) and 1e-4 of JAX's sharded step; bf16 loss within
twice JAX's own sharded-vs-single gap; prefill logits and caches within
1e-5 of each leaf's scale (xlstm's within 1e-4, the bar its states have
against JAX in tests/test_torch_lm_serve.py), greedy ids equal.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import transformer as JT  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config, get_rule_overrides  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch.dryrun import fake_group  # noqa: E402
from repro_torch.launch.mesh import (BASE_RULES, build_rules, local_range,  # noqa: E402
                                     make_production_mesh, make_test_mesh, to_placements)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import params as prm  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import SHAPES, cell_applicable  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD, T_SUB = 8, 600
ENV = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
       "HOME": os.environ.get("HOME", str(ROOT)), "PYTHONPATH": str(ROOT / "src"),
       "JAX_PLATFORMS": "cpu", "GLOO_SOCKET_IFNAME": "lo", "OMP_NUM_THREADS": "1"}
SERVE_ARCHS = ("granite-3-2b", "xlstm-350m", "qwen3-moe-30b-a3b")

JAX_SCRIPT = r'''
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec
from repro.configs import ARCH_IDS, get_config, get_rule_overrides
from repro.launch import specs as S
from repro.launch.mesh import build_rules, set_mesh
from repro.models import transformer as T
from repro.models.config import SHAPES, cell_applicable
from repro.models.layers import set_logical_rules
from repro.train import optimizer as opt
from repro.train.train_loop import make_train_step

out_dir = sys.argv[1]
devs = jax.devices()
ks = jax.tree_util.keystr
is_spec = lambda x: isinstance(x, PartitionSpec)

def leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_spec)[0]

def entry(e):
    return list(e) if isinstance(e, tuple) else e

table = {}
meshes = {False: jax.make_mesh((16, 16), ("data", "model"), devices=devs[:256],
                               axis_types=(AxisType.Auto,) * 2),
          True: jax.make_mesh((2, 16, 16), ("pod", "data", "model"),
                              axis_types=(AxisType.Auto,) * 3)}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    shapes = {ks(p): d.shape for p, d in jax.tree_util.tree_flatten_with_path(
        T.model_defs(cfg), is_leaf=lambda x: hasattr(x, "axes"))[0]}
    for mp, mesh in meshes.items():
        for name, cell in SHAPES.items():
            if not cell_applicable(cfg, cell)[0]:
                continue
            rules = build_rules(get_rule_overrides(arch), multi_pod=mp,
                                batch_size=cell.global_batch)
            if cell.kind == "decode":
                rules = S.serve_rules(cfg, rules)
            rec = {"params": {}, "cache": {}}
            for p, sp in leaves(T.param_pspecs(cfg, rules)):
                rec["params"][ks(p)] = [[entry(e) for e in sp],
                                        list(NamedSharding(mesh, sp).shard_shape(shapes[ks(p)]))]
            if cfg.has_decode and cell.kind != "train":
                cdefs = dict(leaves(T.cache_defs(cfg, cell.global_batch, cell.seq_len)))
                for p, sp in leaves(T.cache_pspecs(cfg, cell.global_batch, cell.seq_len, rules)):
                    rec["cache"][ks(p)] = [[entry(e) for e in sp],
                                           list(NamedSharding(mesh, sp).shard_shape(cdefs[p].shape))]
            table[f"{arch}|{int(mp)}|{name}"] = rec
try:
    NamedSharding(meshes[False], PartitionSpec("model")).shard_shape((10,))
    table["uneven"] = "no error"
except ValueError as e:
    table["uneven"] = "ValueError: " + str(e)
from repro.launch.mesh import make_production_mesh, make_test_mesh
table["mesh_ids"] = {"single": make_production_mesh().device_ids.tolist(),
                     "multi": make_production_mesh(multi_pod=True).device_ids.tolist(),
                     "test_2x2": make_test_mesh((2, 2)).device_ids.tolist()}
with open(os.path.join(out_dir, "table.json"), "w") as f:
    json.dump(table, f)

inp = dict(np.load(os.path.join(out_dir, "batches.npz")))
mesh8 = jax.make_mesh((2, 4), ("data", "model"), devices=devs[:8],
                      axis_types=(AxisType.Auto,) * 2)
res = {}
base = get_config("granite-3-2b").smoke_config()
params0 = T.init_params(jax.random.PRNGKey(0), base)
lr_fn = opt.warmup_cosine(1e-3, 5, 100)
for tag, cdt in (("f32", "float32"), ("bf16", "bfloat16")):
    cfg = base.replace(compute_dtype=cdt)
    rules = build_rules({}, batch_size=8)
    rules["heads"] = None
    for kind in ("sharded", "single"):
        set_logical_rules(rules if kind == "sharded" else {})
        step = jax.jit(make_train_step(cfg, lr_fn, accum=2))
        params = params0
        if kind == "sharded":
            with set_mesh(mesh8):
                params = jax.device_put(params, jax.tree.map(
                    lambda s: NamedSharding(mesh8, s), T.param_pspecs(cfg, rules)))
                ost = opt.init(params)
                for i in range(3):
                    params, ost, m = step(params, ost, {"tokens": inp[f"tokens{i}"],
                                                        "labels": inp[f"labels{i}"]})
                    res[f"{tag}_{kind}_loss{i}"] = np.asarray(m["loss"])
        else:
            ost = opt.init(params)
            for i in range(3):
                params, ost, m = step(params, ost, {"tokens": inp[f"tokens{i}"],
                                                    "labels": inp[f"labels{i}"]})
                res[f"{tag}_{kind}_loss{i}"] = np.asarray(m["loss"])
        res.update({f"{tag}_{kind}" + ks(p): np.asarray(v)
                    for p, v in jax.tree_util.tree_flatten_with_path(params)[0]})
np.savez(os.path.join(out_dir, "jax.npz"), **res)
print("OK")
'''

RANK_SCRIPT = r'''
import sys
from datetime import timedelta
import numpy as np, torch, torch.distributed as dist
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_config, get_rule_overrides
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import build_rules, make_test_mesh, set_mesh
from repro_torch.models import params as prm, transformer as T
from repro_torch.models.layers import set_logical_rules
from repro_torch.serve.engine import make_prefill_step, make_serve_step
from repro_torch.train import optimizer as opt
from repro_torch.train.train_loop import make_train_step

rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                        world_size=world, timeout=timedelta(seconds=300))
mesh = make_test_mesh((2, 4), device_type="cpu")
st = torch.load(f"{tmp}/state.pt", weights_only=False)
whole = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
out = {}

def steps(cfg, params, rules):
    """3 steps of accum 2 from params; sharded under rules (None: one device)."""
    step = make_train_step(cfg, opt.warmup_cosine(1e-3, 5, 100), accum=2)
    params = prm.tree_map(lambda a: a.clone(), params)
    losses = []
    if rules is None:
        ost = opt.init(params)
        for b in st["batches"]:
            params, ost, m = step(params, ost, b)
            losses.append(m["loss"])
        return torch.stack(losses), params
    set_logical_rules(rules)
    bspec = {"tokens": (rules["batch"], None), "labels": (rules["batch"], None)}
    with set_mesh(mesh):
        params = prm.distribute(params, T.param_pspecs(cfg, rules), mesh)
        ost = opt.init(params)
        for b in st["batches"]:
            params, ost, m = step(params, ost, prm.distribute(b, bspec, mesh))
            losses.append(whole(m["loss"]))
    set_logical_rules({})
    return torch.stack(losses), prm.tree_map(whole, params)

base = get_config("granite-3-2b").smoke_config()
for tag, cdt in (("f32", "float32"), ("bf16", "bfloat16")):
    cfg = base.replace(compute_dtype=cdt)
    rules = build_rules({}, batch_size=8)
    rules["heads"] = None                       # as tests/test_distributed.py
    out[f"{tag}_sharded"] = steps(cfg, st["params"], rules)
    if rank == 0:
        out[f"{tag}_single"] = steps(cfg, st["params"], None)
cfg = base.replace(compute_dtype="float32")
rules = build_rules({}, batch_size=8, dp_degree=2)   # the batch over "data" too
rules["heads"] = None
out["dp2_sharded"] = steps(cfg, st["params"], rules)

# one real step of the dry run's train cell, counted by the op analysis
from repro_torch.launch.dryrun import place_out
from repro_torch.launch.op_analysis import analyze
from repro_torch.models.config import ShapeCell
cell = ShapeCell("rank", 32, 8, "train")
fn, _, in_sh, out_sh = S.train_cell_specs(base, cell, rules, False)
set_logical_rules(rules)
with set_mesh(mesh):
    args = [prm.distribute(prm.tree_map(lambda a: a.clone(), st["params"]), in_sh[0], mesh)]
    args.append(opt.init(args[0]))
    args.append(prm.distribute(st["batches"][0], in_sh[2], mesh))
    fn(*args)                                   # DTensor's propagation cache warm
    an = analyze(lambda *a: place_out(fn(*a), out_sh, mesh), *args)   # as count_cell
set_logical_rules({})
out["count"] = {k: an[k] for k in ("flops", "flops_by_dtype", "collectives",
                                   "argument_bytes", "host_syncs")}

B, P, MAX, NEW = 8, 16, 32, 4
for arch in st["serve_archs"]:
    cfg = get_config(arch).smoke_config().replace(compute_dtype="float32")
    params, tokens = st[arch]["params"], st[arch]["tokens"]
    pre, step = make_prefill_step(cfg, MAX), make_serve_step(cfg)
    rules = build_rules(get_rule_overrides(arch), batch_size=B, dp_degree=2)
    srules = S.serve_rules(cfg, rules)
    with torch.no_grad():
        if rank == 0:       # the unsharded port on each data rank's rows
            ref = []
            for rows in (slice(0, B // 2), slice(B // 2, B)):
                logits, caches = pre(params, {"tokens": tokens[rows]})
                first = prm.tree_map(lambda a: a.clone(), caches)
                tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
                ids = [tok]
                for i in range(NEW):
                    tok, caches = step(params, tok, caches, P + i)
                    ids.append(tok)
                ref.append((logits, first, caches, torch.cat(ids, 1)))
            out[arch + "_ref"] = ref
        set_logical_rules(rules)
        with set_mesh(mesh):
            dp = prm.distribute(params, T.param_pspecs(cfg, rules), mesh)
            logits, caches = pre(dp, prm.distribute({"tokens": tokens},
                                                    {"tokens": (rules["batch"], None)}, mesh))
            first = prm.tree_map(whole, caches)
            logits = whole(logits)
            set_logical_rules(srules)
            dp = prm.distribute(params, T.param_pspecs(cfg, srules), mesh)
            caches = prm.distribute(caches, T.cache_pspecs(cfg, B, MAX, srules), mesh)
            tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
            ids = [tok]
            for i in range(NEW):
                tok, caches = step(dp, tok, caches, P + i)
                tok = whole(tok)
                ids.append(tok)
            out[arch] = (logits, first, prm.tree_map(whole, caches), torch.cat(ids, 1))
        set_logical_rules({})
if rank == 0:
    torch.save(out, f"{tmp}/rank0.pt")
dist.destroy_process_group()
print("OK", rank)
'''


def _nested(flat: dict, prefix: str) -> dict:
    """{prefix + "['a']['b']": array} → {"a": {"b": tensor}}."""
    tree = {}
    for key, a in flat.items():
        if not key.startswith(prefix + "["):
            continue
        parts = re.findall(r"\['([^']+)'\]", key[len(prefix):])
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(a))
    return tree


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's table and steps, and the 8 gloo ranks' results (run once)."""
    tmp = tmp_path_factory.mktemp("sharding")
    rng = np.random.default_rng(0)
    batches = {f"{k}{i}": rng.integers(0, 256, (8, 32)).astype(np.int32)
               for i in range(3) for k in ("tokens", "labels")}
    np.savez(tmp / "batches.npz", **batches)
    jax_proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(tmp)], cwd=ROOT,
                                env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
    jcfg = jget_config("granite-3-2b").smoke_config()
    flat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(JT.init_params(jax.random.PRNGKey(0), jcfg))[0]}
    state = {"params": _nested(flat, ""),
             "batches": [{"tokens": torch.from_numpy(batches[f"tokens{i}"]),
                          "labels": torch.from_numpy(batches[f"labels{i}"])} for i in range(3)],
             "serve_archs": SERVE_ARCHS}
    g = torch.Generator().manual_seed(3)
    for arch in SERVE_ARCHS:
        cfg = get_config(arch).smoke_config()
        state[arch] = {"params": T.init_params(torch.Generator().manual_seed(1), cfg, device="cpu"),
                       "tokens": torch.randint(0, cfg.vocab_size, (8, 16), generator=g)}
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
    with open(tmp / "table.json") as f:
        table = json.load(f)
    return {"state": state, "table": table, "jax": dict(np.load(tmp / "jax.npz")),
            "port": torch.load(tmp / "rank0.pt", weights_only=False)}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a − b| over b's largest |value|."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _params_rel(got: dict, want: dict) -> float:
    return max(_rel(a, want[p]) for p, a in prm.leaf_paths(got))


# ------------------------------------------------------------- mesh, rules

def test_rules_equal_jax_for_every_config_and_cell():
    assert BASE_RULES == jmesh.BASE_RULES
    for arch in ARCH_IDS:
        for mp in (False, True):
            for cell in SHAPES.values():
                for dp in (2, 16):
                    got = build_rules(get_rule_overrides(arch), multi_pod=mp,
                                      batch_size=cell.global_batch, dp_degree=dp)
                    assert got == jmesh.build_rules(get_rule_overrides(arch), multi_pod=mp,
                                                    batch_size=cell.global_batch,
                                                    dp_degree=dp), (arch, mp, cell)


def test_to_placements_maps_each_mesh_dim():
    fake_group(8)
    try:
        mesh = make_test_mesh((2, 4), device_type="cpu")
        assert to_placements(mesh, ("data", None, "model")) == (Shard(0), Shard(2))
        assert to_placements(mesh, (None, "model")) == (Replicate(), Shard(1))
        assert to_placements(mesh, (("data", "model"), None)) == (Shard(0), Shard(0))
        assert to_placements(mesh, ()) == (Replicate(), Replicate())
        with pytest.raises(ValueError, match="minor to major"):
            to_placements(mesh, (("model", "data"),))
        with pytest.raises(ValueError, match="used twice"):
            to_placements(mesh, ("data", "data"))
    finally:
        dist.destroy_process_group()


def test_production_mesh_refuses_another_world_size():
    fake_group(8)
    try:
        with pytest.raises(RuntimeError, match="need 256 devices"):
            make_production_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


def _fake_rank(world: int, rank: int) -> None:
    """A fake default group of `world` ranks, this process rank `rank`."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)


@pytest.mark.parametrize("rank", [0, 300])
def test_production_mesh_holds_the_first_256_of_512_ranks(rank):
    """At a world of 512 the (16, 16) mesh is ranks arange(256), row-major,
    as JAX takes its first 256 devices: rank 0 sits at (0, 0); rank 300
    is outside it, and its shard of a distributed parameter is empty."""
    _fake_rank(512, rank)
    try:
        mesh = make_production_mesh(device_type="cpu")
        assert torch.equal(mesh.mesh, torch.arange(256).view(16, 16))
        w = prm.distribute({"w": torch.ones(32, 48)}, {"w": ("data", "model")}, mesh)["w"]
        assert tuple(w.shape) == (32, 48)
        if rank == 0:
            assert tuple(mesh.get_coordinate()) == (0, 0)
            assert tuple(w.to_local().shape) == (2, 3)
        else:
            assert mesh.get_coordinate() is None
            assert w.to_local().numel() == 0
            assert local_range((32, 48), mesh, to_placements(mesh, ("data", "model"))) \
                == ((0, 0), (0, 0))
    finally:
        dist.destroy_process_group()


def test_multi_pod_mesh_holds_the_first_512_of_600_ranks():
    _fake_rank(600, 0)
    try:
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        assert torch.equal(mesh.mesh, torch.arange(512).view(2, 16, 16))
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert tuple(mesh.get_coordinate()) == (0, 0, 0)
    finally:
        dist.destroy_process_group()


def test_meshes_hold_the_ranks_jax_meshes_hold_devices(run):
    """JAX's `make_production_mesh` (both) and `make_test_mesh((2, 2))`
    over 512 host devices hold the device ids the port's meshes hold as
    ranks: the production meshes at a world of 512, the test mesh at 8."""
    ids = run["table"]["mesh_ids"]
    for multi, key in ((False, "single"), (True, "multi")):
        fake_group(512)
        try:
            assert make_production_mesh(multi_pod=multi, device_type="cpu").mesh.tolist() \
                == ids[key], key
        finally:
            dist.destroy_process_group()
    fake_group(8)
    try:
        assert make_test_mesh((2, 2), device_type="cpu").mesh.tolist() == ids["test_2x2"]
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("rank", [0, 300])
def test_train_mesh_single_sits_out_past_the_mesh(rank, tmp_path, monkeypatch, capsys):
    """`launch/train.py --mesh single` at a world of 512: every rank builds
    the mesh; rank 0 trains on it, rank 300 prints that it sits out and
    returns (exit 0) without training or writing a checkpoint."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch import train as launch_train

    real_init = dist.init_process_group
    monkeypatch.setenv("WORLD_SIZE", "512")
    monkeypatch.setenv("RANK", str(rank))
    monkeypatch.setattr(dist, "init_process_group", lambda backend: real_init(
        "fake", store=FakeStore(), rank=rank, world_size=512))
    calls = []
    monkeypatch.setattr(launch_train, "train",
                        lambda *a, mesh, **kw: calls.append(tuple(mesh.get_coordinate())))
    try:
        launch_train.main(["--device", "cpu", "--mesh", "single", "--ckpt-dir",
                           str(tmp_path / "ck")])
    finally:
        L.set_logical_rules({})
    assert not dist.is_initialized()
    if rank == 0:
        assert calls == [(0, 0)]
    else:
        assert calls == [] and not (tmp_path / "ck").exists()
        assert "rank 300 of 512 sits out" in capsys.readouterr().out


SIT_OUT_SCRIPT = r'''
import sys
from datetime import timedelta
import torch, torch.distributed as dist
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import for_model
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.layers import set_logical_rules
from repro_torch.train.train_loop import train

rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                        world_size=world, timeout=timedelta(seconds=60))
mesh = make_test_mesh((1, 2), device_type="cpu")
if not launch_train.sits_out(mesh):
    set_logical_rules(launch_train.mesh_rules("granite-3-2b", False, 8, False))
    cfg = get_config("granite-3-2b").smoke_config()
    train(cfg, for_model(cfg, seq_len=32, global_batch=8, mode="markov"), steps=2,
          ckpt_manager=CheckpointManager(f"{tmp}/ck"), ckpt_every=1, device="cpu",
          mesh=mesh)
    dist.destroy_process_group()
print("OK", rank)
'''


def test_mesh_trains_and_checkpoints_after_ranks_past_it_leave(tmp_path):
    """Three gloo ranks (processes) and a (1, 2) mesh over ranks 0-1: rank 2
    sits out and leaves the process group at once, as `launch/train.py`
    has it; ranks 0-1 run the real `train` for 2 steps with a checkpoint
    after each. A checkpoint's barrier holds the mesh's ranks only: one over
    the whole group would wait for rank 2 until gloo's timeout."""
    from repro_torch.ckpt.checkpoint import CheckpointManager

    procs = [subprocess.Popen([sys.executable, "-c", SIT_OUT_SCRIPT, str(r), "3",
                               str(tmp_path)], cwd=ROOT, env=ENV, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(3)]
    try:
        outs = [p.communicate(timeout=T_SUB) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0 and "OK" in o, e[-4000:]
    assert "rank 2 of 3 sits out" in outs[2][0]
    assert "sits out" not in outs[0][0] + outs[1][0]
    assert CheckpointManager(str(tmp_path / "ck")).latest_step() == 2


def test_uneven_dim_jax_refuses_torch_chunks(run):
    """JAX's `shard_shape` refuses 10 rows over a 16-way axis; DTensor's
    `Shard` places them as `torch.chunk` does (1 row on ranks 0-9, none
    after); no config's rules meet this (the table test)."""
    assert run["table"]["uneven"].startswith("ValueError")
    fake_group(256)
    try:
        mesh = make_production_mesh(device_type="cpu")
        t = prm.distribute({"x": torch.empty(10, device="meta")}, {"x": ("model",)}, mesh)["x"]
        assert tuple(t.to_local().shape) == (1,)
        assert local_range((10,), mesh, to_placements(mesh, ("model",))) == ((0,), (1,))
        assert [len(c) for c in torch.chunk(torch.arange(10), 16)] == [1] * 10
    finally:
        dist.destroy_process_group()


def _flat_cache(tree) -> dict:
    """{JAX keystr: leaf} of a cache tree (dict of NamedTuples)."""
    return {f"[{k!r}].{f}": leaf for k, st in tree.items()
            for f, leaf in zip(st._fields, st)}


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_param_and_cache_specs_and_shard_shapes_equal_jax(run, multi_pod):
    """Every config × cell: each parameter's and cache leaf's spec equals
    JAX's, and its local shard on the production mesh (a fake group of
    256 / 512 ranks, meta tensors) equals JAX's `shard_shape`."""
    fake_group(512 if multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        n = 0
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            for name, cell in SHAPES.items():
                if not cell_applicable(cfg, cell)[0]:
                    continue
                want = run["table"][f"{arch}|{int(multi_pod)}|{name}"]
                rules = build_rules(get_rule_overrides(arch), multi_pod=multi_pod,
                                    batch_size=cell.global_batch)
                if cell.kind == "decode":
                    rules = S.serve_rules(cfg, rules)
                specs = T.param_pspecs(cfg, rules)
                placed = prm.distribute(T.abstract_params(cfg), specs, mesh)
                got = {p: [[list(e) if isinstance(e, tuple) else e for e in sp],
                            list(dict(prm.leaf_paths(placed))[p].to_local().shape)]
                       for p, sp in prm.leaf_paths(specs)}
                assert got == want["params"], (arch, name)
                if cfg.has_decode and cell.kind != "train":
                    cspec = T.cache_pspecs(cfg, cell.global_batch, cell.seq_len, rules)
                    cache = prm.distribute(T.cache_defs(cfg, cell.global_batch, cell.seq_len),
                                           cspec, mesh)
                    got = {p: [[list(e) if isinstance(e, tuple) else e for e in sp],
                                list(_flat_cache(cache)[p].to_local().shape)]
                           for p, sp in _flat_cache(cspec).items()}
                    assert got == want["cache"], (arch, name)
                n += 1
        assert n >= 30
    finally:
        dist.destroy_process_group()


def test_param_pspecs_equal_jax_in_process():
    """The spec trees themselves against JAX's `PartitionSpec`s."""
    for arch in ARCH_IDS:
        rules = build_rules(get_rule_overrides(arch), multi_pod=True, batch_size=1)
        want = jax.tree_util.tree_flatten_with_path(
            JT.param_pspecs(jget_config(arch), rules),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
        got = dict(prm.leaf_paths(T.param_pspecs(get_config(arch), rules)))
        assert {jax.tree_util.keystr(p): tuple(s) for p, s in want} == got, arch


# ----------------------------------------------------------------- shard()

def test_shard_without_rules_or_mesh_returns_x():
    x = torch.ones(4, 8)
    L.set_logical_rules({})
    assert L.shard(x, "batch", "embed") is x
    L.set_logical_rules(BASE_RULES)
    try:
        assert L.shard(x, "batch", "embed") is x          # a plain tensor: no mesh
        assert L.get_logical_rules() == BASE_RULES
    finally:
        L.set_logical_rules({})


def test_shard_redistributes_a_dtensor_to_its_rules():
    fake_group(8)
    L.set_logical_rules({"batch": "data", "mlp": "model"})
    try:
        mesh = make_test_mesh((2, 4), device_type="cpu")
        x = prm.distribute({"x": torch.empty(8, 16, 32, device="meta")},
                           {"x": (None, None, None)}, mesh)["x"]
        y = L.shard(x, "batch", None, "mlp")
        assert y.placements == (Shard(0), Shard(2))
        assert tuple(y.to_local().shape) == (4, 16, 8)
        assert L.shard(y, "batch", None, "mlp") is y
    finally:
        L.set_logical_rules({})
        dist.destroy_process_group()


# ------------------------------------------------- train / prefill / decode

def test_train_f32_matches_unsharded_port(run):
    losses, params = run["port"]["f32_sharded"]
    ref_losses, ref_params = run["port"]["f32_single"]
    assert _rel(losses, ref_losses) < 1e-5, (losses, ref_losses)
    assert _params_rel(params, dict(prm.leaf_paths(ref_params))) < 1e-5


def test_train_f32_matches_jax_sharded_step(run):
    j = run["jax"]
    want = torch.tensor([float(j[f"f32_sharded_loss{i}"]) for i in range(3)])
    losses, params = run["port"]["f32_sharded"]
    assert _rel(losses, want) < 1e-4, (losses, want)
    jp = {k[len("f32_sharded"):]: torch.from_numpy(v) for k, v in j.items()
          if k.startswith("f32_sharded[")}
    assert _params_rel(params, jp) < 1e-4


def test_train_bf16_within_twice_jax_own_gap(run):
    """At the config's bf16 compute the port's sharded-vs-unsharded loss
    gap is at most twice JAX's own sharded-vs-single gap on the same
    inputs (each the largest relative gap over the 3 steps)."""
    j = run["jax"]
    jgap = max(abs(float(j[f"bf16_sharded_loss{i}"]) - float(j[f"bf16_single_loss{i}"]))
               / abs(float(j[f"bf16_single_loss{i}"])) for i in range(3))
    got, ref = run["port"]["bf16_sharded"][0], run["port"]["bf16_single"][0]
    gap = float(((got - ref).abs() / ref.abs()).max())
    assert 0 < jgap and gap <= 2 * jgap, (gap, jgap)


def test_train_with_batch_over_data_matches_unsharded(run):
    """The same steps with the batch sharded over "data" too (dp 2): each
    micro-batch a share of every data rank's rows."""
    losses, params = run["port"]["dp2_sharded"]
    ref_losses, ref_params = run["port"]["f32_single"]
    assert _rel(losses, ref_losses) < 1e-5
    assert _params_rel(params, dict(prm.leaf_paths(ref_params))) < 1e-5


def test_dry_run_counts_equal_a_real_ranks_count(run):
    """The dry run of a (2, 4) train cell (meta DTensors, a fake group of
    8) counts what rank 0 of the real gloo group counted of the same step
    on real tensors: product FLOPs, collectives, argument bytes."""
    from repro_torch.launch.dryrun import count_cell
    from repro_torch.models.config import ShapeCell

    rules = build_rules({}, batch_size=8, dp_degree=2)
    rules["heads"] = None
    fake_group(8)
    try:
        mesh = make_test_mesh((2, 4), device_type="cpu")
        meta = count_cell(get_config("granite-3-2b").smoke_config(),
                          ShapeCell("rank", 32, 8, "train"), rules, mesh, False)
    finally:
        dist.destroy_process_group()
    real = run["port"]["count"]
    assert meta["flops"] == real["flops"] and meta["flops_by_dtype"] == real["flops_by_dtype"]
    assert meta["collectives"] == real["collectives"]
    assert meta["argument_bytes"] == real["argument_bytes"]
    assert real["host_syncs"] == []


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_prefill_and_decode_match_unsharded_port(run, arch):
    logits, first, caches, ids = run["port"][arch]
    ref = run["port"][arch + "_ref"]
    bar = 1e-4 if arch == "xlstm-350m" else 1e-5
    assert _rel(logits, torch.cat([r[0] for r in ref])) < 1e-5
    for got, k in ((first, 1), (caches, 2)):
        for key, st in got.items():
            for f, leaf in zip(st._fields, st):
                want = torch.cat([getattr(r[k][key], f) for r in ref], dim=1)
                assert _rel(leaf, want) < bar, (key, f)
    assert torch.equal(ids, torch.cat([r[3] for r in ref]))
