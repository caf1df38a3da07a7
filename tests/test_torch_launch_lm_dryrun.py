"""The LM dry run (`launch/specs.py`, `launch/dryrun.run_cell` / `main`,
`launch/profile_cell.py`), the op counter on DTensors and
`launch/train.py --mesh / --no-fsdp`, against the JAX package on the CPU.

One JAX subprocess (8 virtual CPU devices, mesh (2, 4) with
`AxisType.Auto`) lowers the cells of tests/test_dryrun_small.py (granite's
smoke config, `build_rules({"heads": None, "kv_heads": None},
batch_size=8, dp_degree=2)`, a train and a decode cell of seq 64, batch
8) and counts them with `hlo_analysis`; the port counts the same cells on
a fake group of 8 ranks with meta DTensors (`dryrun.count_cell`).

Named departures, each pinned by a test:
- product FLOPs: with neither heads nor kv_heads sharded, GSPMD splits
  the q / k / v projections' contraction (d_model) 4 ways over "model"
  and all-reduces their outputs, where the port computes them whole on
  every model rank: the port counts 3/4 of those products more, once in
  the train step (JAX splits one of its three passes over them) and once
  in decode;
- argument bytes: the decode position is a Python int in the port, an
  int32 scalar argument in JAX (4 bytes);
- collectives: GSPMD picks its own (collective-permutes, all-to-alls);
  DTensor's are all-gathers, all-reduces and reduce-scatters. Both are
  printed side by side; the port's are pinned to their own counts.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import specs as JS  # noqa: E402
from repro.models.config import SHAPES as JSHAPES  # noqa: E402
from repro.models.config import cell_applicable as jcell_applicable  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config, get_rule_overrides  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import build_rules, make_production_mesh, make_test_mesh  # noqa: E402
from repro_torch.launch.op_analysis import analyze  # noqa: E402
from repro_torch.launch.profile_cell import profile  # noqa: E402
from repro_torch.models.config import SHAPES, ShapeCell, cell_applicable  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ENV = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
       "HOME": os.environ.get("HOME", str(ROOT)), "PYTHONPATH": str(ROOT / "src"),
       "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
TINY = {"train": ShapeCell("tiny_train", 64, 8, "train"),
        "decode": ShapeCell("tiny_decode", 64, 8, "decode")}

JAX_SCRIPT = r'''
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from jax.sharding import AxisType
from repro.configs import get_config
from repro.launch.mesh import build_rules, set_mesh, to_shardings
from repro.launch import specs as S
from repro.launch.hlo_analysis import analyze
from repro.models.config import ShapeCell
from repro.models.layers import set_logical_rules
cfg = get_config("granite-3-2b").smoke_config()
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
rules = build_rules({"heads": None, "kv_heads": None}, batch_size=8, dp_degree=2)
set_logical_rules(rules)
out = {}
for kind, donate in (("train", (0, 1)), ("decode", (2,))):
    cell = ShapeCell("tiny_" + kind, 64, 8, kind)
    fn, args, insh, outsh = (S.train_cell_specs(cfg, cell, rules, False) if kind == "train"
                             else S.decode_cell_specs(cfg, cell, rules))
    with set_mesh(mesh):
        compiled = jax.jit(fn, in_shardings=to_shardings(mesh, insh),
                           out_shardings=to_shardings(mesh, outsh),
                           donate_argnums=donate).lower(*args).compile()
        mem = compiled.memory_analysis()
    r = analyze(compiled.as_text())
    out[kind] = {"flops": r["flops"], "argument_bytes": mem.argument_size_in_bytes,
                 "collectives": {k: v for k, v in r["collectives"].items() if v["count"]}}
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
print("OK")
'''


@pytest.fixture(scope="module")
def jax_tiny(tmp_path_factory):
    path = tmp_path_factory.mktemp("lm_dryrun") / "jax.json"
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(path)], cwd=ROOT, env=ENV,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-4000:]
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def port_tiny():
    cfg = get_config("granite-3-2b").smoke_config()
    rules = build_rules({"heads": None, "kv_heads": None}, batch_size=8, dp_degree=2)
    D.fake_group(8)
    try:
        mesh = make_test_mesh((2, 4), device_type="cpu")
        return {k: D.count_cell(cfg, cell, rules, mesh, False) for k, cell in TINY.items()}
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------ op counter, DTensor

def test_op_counter_counts_one_devices_matmul_and_dtensors_all_gather():
    """x (256, 4096, 2048) [Shard(0), Replicate()] · w (2048, 8192)
    [Shard(0), Shard(1)] on a fake (16, 16) mesh: DTensor gathers w over
    "data" (one all-gather of a (2048, 512) f32 block) and each device
    multiplies its 16 rows by its 512 columns: the global FLOPs / 256."""
    D.fake_group(256)
    try:
        mesh = make_production_mesh(device_type="cpu")
        x = DTensor.from_local(torch.empty((16, 4096, 2048), device="meta"), mesh,
                               [Shard(0), Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty((128, 512), device="meta"), mesh,
                               [Shard(0), Shard(1)], run_check=False)
        r = analyze(lambda a, b: a @ b, x, w)
    finally:
        dist.destroy_process_group()
    assert r["flops"] == 2 * 256 * 4096 * 2048 * 8192 / 256
    assert r["collectives"]["all-gather"] == {"count": 1.0, "bytes": 2048 * 512 * 4}
    assert r["collective_bytes_total"] == 2048 * 512 * 4
    assert r["argument_bytes"] == (16 * 4096 * 2048 + 128 * 512) * 4      # the shards
    assert r["output_bytes"] == 16 * 4096 * 512 * 4


# ------------------------------------------------------------ specs vs JAX

def test_model_flops_and_param_count_equal_jax():
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        assert S.param_count(cfg) == JS.param_count(jcfg), arch
        for name, cell in SHAPES.items():
            assert S.model_flops(cfg, cell) == JS.model_flops(jcfg, JSHAPES[name]), (arch, name)
        for name in ("train_4k", "decode_32k"):
            rules = build_rules(get_rule_overrides(arch), batch_size=SHAPES[name].global_batch)
            assert S.serve_rules(cfg, rules) == JS.serve_rules(jcfg, rules), arch


def test_cell_applicable_skips_equal_jax_and_run_cell_reports_them():
    for arch in ARCH_IDS:
        for name, cell in SHAPES.items():
            assert cell_applicable(get_config(arch), cell) == \
                jcell_applicable(jget_config(arch), JSHAPES[name]), (arch, name)
    r = D.run_cell("granite-3-2b", "long_500k", False)
    assert r == {"arch": "granite-3-2b", "shape": "long_500k", "mesh": "single",
                 "skipped": jcell_applicable(jget_config("granite-3-2b"),
                                             JSHAPES["long_500k"])[1]}
    assert "SKIP" in D.fmt_summary(r)


def test_cell_specs_have_jax_shapes_and_specs():
    """Each cell's abstract batch / token arguments have JAX's shapes,
    dtypes and specs; serving weights are bf16."""
    cfg, jcfg = get_config("granite-3-2b"), jget_config("granite-3-2b")
    rules = build_rules({}, batch_size=128)
    _, args, in_sh, _ = S.train_cell_specs(cfg, SHAPES["train_4k"], rules, False)
    _, jargs, jin, _ = JS.train_cell_specs(jcfg, JSHAPES["train_4k"], rules, False)
    for k in ("tokens", "labels"):
        assert tuple(args[2][k].shape) == jargs[2][k].shape
        assert in_sh[2][k] == tuple(jin[2][k])
    _, args, in_sh, _ = S.prefill_cell_specs(cfg, SHAPES["prefill_32k"], rules)
    _, jargs, jin, _ = JS.prefill_cell_specs(jcfg, JSHAPES["prefill_32k"], rules)
    assert tuple(args[1]["tokens"].shape) == jargs[1]["tokens"].shape
    assert args[0]["head"]["w"].dtype == torch.bfloat16
    _, args, in_sh, _ = S.decode_cell_specs(cfg, SHAPES["decode_32k"], rules)
    _, jargs, jin, _ = JS.decode_cell_specs(jcfg, JSHAPES["decode_32k"], rules)
    assert tuple(args[1].shape) == jargs[1].shape and in_sh[1] == tuple(jin[1])
    assert args[3] == 0 and in_sh[3] is None
    assert S.train_accum(cfg, 16) == JS.train_accum(jcfg, 16) == 8


# ------------------------------------------------- the (2, 4) cells vs JAX

def _departure_flops(cfg, tokens: int) -> float:
    """3/4 of the q/k/v projections' products of every layer, once."""
    return cfg.n_layers * 0.75 * 2 * tokens * cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_tiny_cells_against_jax(kind, jax_tiny, port_tiny):
    cfg = get_config("granite-3-2b").smoke_config()
    want, got = jax_tiny[kind], port_tiny[kind]
    print(f"{kind}: FLOPs port {got['flops']:.0f} JAX {want['flops']:.0f}; collectives "
          f"port {{ {', '.join(f'{k}: {v}' for k, v in got['collectives'].items() if v['count'])} }} "
          f"JAX {want['collectives']}")
    local_tokens = 4 * (64 if kind == "train" else 1)            # batch 8 over data 2
    assert got["flops"] - want["flops"] == _departure_flops(cfg, local_tokens)
    assert got["flops_by_dtype"] == {"bfloat16": got["flops"]}
    assert got["argument_bytes"] == want["argument_bytes"] - (4 if kind == "decode" else 0)
    assert got["host_syncs"] == []
    colls = {k: v for k, v in got["collectives"].items() if v["count"]}
    pinned = {"train": {"all-reduce": {"count": 32.0, "bytes": 365620.0},
                        "all-gather": {"count": 28.0, "bytes": 395264.0},
                        "reduce-scatter": {"count": 13.0, "bytes": 81920.0}},
              "decode": {"all-reduce": {"count": 9.0, "bytes": 2816.0},
                         "all-gather": {"count": 17.0, "bytes": 90304.0}}}[kind]
    assert colls == pinned


# ------------------------------------------------------- run_cell and CLIs

def test_run_cell_writes_jax_keys(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    r = D.run_cell("granite-3-2b", "decode_32k", False)
    assert set(r) >= {"arch", "shape", "mesh", "rules", "lower_s", "compile_s", "per_device",
                      "memory", "collectives", "collective_bytes_total", "roofline", "n_chips"}
    assert set(r["roofline"]) >= {"compute_s", "memory_s", "collective_s", "dominant",
                                  "model_flops_total", "model_flops_per_device",
                                  "useful_flops_ratio", "bound_step_s"}
    assert r["n_chips"] == 256 and r["rules"]["embed"] == "None"     # serve_rules
    cfg = get_config("granite-3-2b")
    assert r["roofline"]["model_flops_total"] == S.model_flops(cfg, SHAPES["decode_32k"])
    # the decode step's parameters: bf16, vocab / heads / mlp over 16 "model" ranks
    assert r["memory"]["argument_bytes"] > S.param_count(cfg) * 2 / 16
    assert r["collectives"]["all-reduce"]["count"] > 0 and "all-to-all" not in r["collectives"]
    with open(tmp_path / "artifacts" / "dryrun_torch" / "granite-3-2b_decode_32k_single.json") as f:
        assert json.load(f) == json.loads(json.dumps(r))
    assert not dist.is_initialized()


def test_dryrun_main_and_profile_cell_print(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    D.main(["--arch", "granite-3-2b", "--shape", "decode_32k", "--mesh", "both"])
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "all cells passed"
    assert [line.split()[2] for line in out[:-1]] == ["single", "multi"]
    r = profile("granite-3-2b", "decode_32k", top_n=5)
    out = capsys.readouterr().out
    assert "-- top HBM contributors:" in out and "-- top collective contributors:" in out
    assert len(r["top_hbm"]) == 5 and r["top_coll"][0]["op"] == "all-reduce"


# --------------------------------------------------------- train --mesh

def test_mesh_rules_equal_jax_for_every_config_shape_and_flag():
    for arch in ARCH_IDS:
        for multi in (False, True):
            for batch in (1, 8, 256):
                for no_fsdp in (False, True):
                    want = jmesh.build_rules(get_rule_overrides(arch), multi_pod=multi,
                                             batch_size=batch)
                    if no_fsdp:
                        want["embed"] = None
                    assert launch_train.mesh_rules(arch, multi, batch, no_fsdp) == want


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_train_mesh_refuses_outside_its_world(mesh, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    n = 256 if mesh == "single" else 512
    with pytest.raises(SystemExit, match=f"need {n} devices"):
        launch_train.main(["--device", "cpu", "--mesh", mesh])
    assert not dist.is_initialized()


def test_train_on_a_mesh_runs_and_writes_a_whole_checkpoint(tmp_path):
    """`train(mesh=)` on a fake (2, 4) group (its collectives move nothing,
    so only the path and the shapes are checked): the parameters stay
    DTensors, and rank 0 writes whole leaves that restore unsharded."""
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import for_model
    from repro_torch.models.layers import set_logical_rules
    from repro_torch.train.train_loop import train

    cfg = get_config("granite-3-2b").smoke_config()
    D.fake_group(8)
    try:
        mesh = make_test_mesh((2, 4), device_type="cpu")
        set_logical_rules(build_rules({}, batch_size=8, dp_degree=2))
        mgr = CheckpointManager(str(tmp_path / "ck"))
        params, ost, losses = train(cfg, for_model(cfg, seq_len=16, global_batch=8), steps=2,
                                    ckpt_manager=mgr, ckpt_every=1, device="cpu", mesh=mesh)
    finally:
        set_logical_rules({})
        dist.destroy_process_group()
    assert isinstance(params["head"]["w"], DTensor) and len(losses) == 2
    back, _, step = mgr.restore_train_state(cfg, device="cpu")
    assert step == 2 and tuple(back["head"]["w"].shape) == (cfg.d_model, cfg.vocab_padded)
    assert not isinstance(back["head"]["w"], DTensor)
