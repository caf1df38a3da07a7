"""The port's checkpoints (`repro_torch.ckpt.checkpoint`) against the JAX
package's on the CPU.

`tests/test_checkpoint.py` case for case on the port (`device=` in place
of `shardings=`), then across the packages: the port's leaf names equal
JAX's `_leaf_names` on the same trees, a JAX `save_train_state` opens in
the port's `restore_train_state` and the port's in JAX's, every leaf bit
for bit, and a tree with a bf16 leaf travels both ways.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.ckpt import checkpoint as jck  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402

from repro_torch.ckpt.checkpoint import (CheckpointManager, _leaf_names,  # noqa: E402
                                         restore, save)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import params as prm  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    workers on the machine's cores, and threads that wait on each other
    there cost more than they give."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree):
    """Leaves in JAX's order (dict keys sorted, NamedTuple fields in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _tree_eq(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _init(cfg):
    return T.init_params(torch.Generator().manual_seed(0), cfg, device=CPU)


# ------------------------------------------ tests/test_checkpoint.py, case for case

def test_roundtrip(tmp_path):
    tree = {"a": torch.arange(10.0), "b": {"c": torch.ones((3, 4), dtype=torch.bfloat16),
                                           "d": torch.tensor(3)}}
    p = str(tmp_path / "ck")
    save(p, tree, step=5)
    back, step, _ = restore(p, tree, device=CPU)
    assert step == 5
    assert _tree_eq(tree, back)
    assert back["b"]["c"].dtype == torch.bfloat16


def test_manager_retention_and_latest(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        m.save(s, {"x": torch.full((2,), float(s))})
    assert m.steps() == [3, 4]
    assert m.latest_step() == 4
    back, step, _ = m.restore({"x": torch.zeros(2)}, device=CPU)
    assert step == 4 and float(back["x"][0]) == 4


def test_atomic_save_overwrites_cleanly(tmp_path):
    p = str(tmp_path / "ck")
    save(p, {"x": torch.zeros(3)}, step=1)
    save(p, {"x": torch.ones(3)}, step=2)
    back, step, _ = restore(p, {"x": torch.zeros(3)}, device=CPU)
    assert step == 2 and float(back["x"][0]) == 1.0


def test_restore_missing_step_is_clear(tmp_path):
    m = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        m.restore({"x": torch.zeros(2)}, device=CPU)
    m.save(3, {"x": torch.zeros(2)})
    with pytest.raises(FileNotFoundError, match="step 7"):
        m.restore({"x": torch.zeros(2)}, step=7, device=CPU)


def test_retention_never_deletes_just_written(tmp_path):
    # keep < 1 is clamped: the newest write always survives
    m = CheckpointManager(str(tmp_path), keep=0)
    m.save(1, {"x": torch.zeros(2)})
    assert m.steps() == [1]
    # an out-of-order save of an OLD step is still the newest write
    m2 = CheckpointManager(str(tmp_path / "b"), keep=1)
    for s in (5, 9, 2):
        m2.save(s, {"x": torch.full((2,), float(s))})
    assert 2 in m2.steps()
    back, step, _ = m2.restore({"x": torch.zeros(2)}, step=2, device=CPU)
    assert step == 2 and float(back["x"][0]) == 2


def test_steps_ignores_stray_dirs(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(4, {"x": torch.zeros(2)})
    for stray in ("notes", "ckpt_abc", "ckpt_00000009.tmp"):
        (tmp_path / stray).mkdir()
    (tmp_path / "ckpt_readme.txt").write_text("hi")
    assert m.steps() == [4]
    assert m.latest_step() == 4


def test_train_state_roundtrip_with_real_model(tmp_path):
    cfg = get_config("granite-3-2b").smoke_config()
    params = _init(cfg)
    ostate = opt.init(params)
    m = CheckpointManager(str(tmp_path))
    m.save_train_state(42, params, ostate)
    p2, o2, data_step = m.restore_train_state(cfg, device=CPU)
    assert data_step == 42
    assert _tree_eq(params, p2)
    assert int(o2.step) == 0 and o2.step.dtype == torch.int32


def test_elastic_restore_lands_on_the_asked_device(tmp_path):
    """`device=` in place of JAX's shardings: the leaves land there (the
    card's case is in test_torch_cuda.py); meta tensors serve as the
    template."""
    tree = {"w": torch.arange(16.0).reshape(4, 4)}
    p = str(tmp_path / "ck")
    save(p, tree, step=0)
    back, _, _ = restore(p, {"w": torch.empty((4, 4), device="meta")}, device=CPU)
    assert back["w"].device.type == "cpu" and torch.equal(back["w"], tree["w"])


def test_restore_without_device_wants_a_card(tmp_path):
    """No silent CPU fallback: the default device is CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = str(tmp_path / "ck")
    save(p, {"x": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restore(p, {"x": torch.zeros(2)})


def test_template_mismatch_raises(tmp_path):
    p = str(tmp_path / "ck")
    save(p, {"x": torch.zeros(2)})
    with pytest.raises(ValueError, match="structure mismatch"):
        restore(p, {"y": torch.zeros(2)}, device=CPU)


# -------------------------------------------------------- across the packages

def _mixed_torch():
    st = opt.AdamWState(torch.tensor(7, dtype=torch.int32), {"a": torch.ones(2)},
                        {"a": torch.full((2,), 2.0)})
    return {"params": {"embed": {"table": torch.arange(6.0).reshape(2, 3)},
                       "groups": {"pos0_attn": {"wq": torch.linspace(-1, 1, 8).to(torch.bfloat16)}}},
            "opt": st, "l": [torch.ones(1, dtype=torch.int32), (torch.zeros(1),)],
            "n": None, "u8": torch.arange(4, dtype=torch.uint8)}


def _as_jax(tree):
    """The same tree in JAX's types (AdamWState → JAX's NamedTuple)."""
    if isinstance(tree, opt.AdamWState):
        return jopt.AdamWState(*(_as_jax(v) for v in tree))
    if isinstance(tree, dict):
        return {k: _as_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_jax(v) for v in tree)
    if tree is None:
        return None
    return jnp.asarray(_np(tree))


def test_leaf_names_equal_jax():
    t = _mixed_torch()
    assert _leaf_names(t) == jck._leaf_names(_as_jax(t))
    cfg = get_config("qwen3-moe-30b-a3b").smoke_config()
    params = _init(cfg)
    tree = {"params": params, "opt": opt.init(params)}
    jcfg = jget_config("qwen3-moe-30b-a3b").smoke_config()
    jp = JT.abstract_params(jcfg)
    assert _leaf_names(tree) == jck._leaf_names({"params": jp, "opt": jopt.AdamWState(
        jax.ShapeDtypeStruct((), np.int32), jp, jp)})


def test_bf16_tree_travels_both_ways(tmp_path):
    t = _mixed_torch()
    save(str(tmp_path / "port"), t, step=3, extra={"by": "port"})
    back, step, extra = jck.restore(str(tmp_path / "port"), _as_jax(t))
    assert step == 3 and extra == {"by": "port"}
    for a, b in zip(_leaves(t), jax.tree.leaves(back)):
        b = np.asarray(b)
        assert b.dtype == _np(a).dtype and b.tobytes() == _np(a).tobytes()
    jck.save(str(tmp_path / "jax"), _as_jax(t), step=4, extra={"by": "jax"})
    back, step, extra = restore(str(tmp_path / "jax"), t, device=CPU)
    assert step == 4 and extra == {"by": "jax"}
    assert back["params"]["groups"]["pos0_attn"]["wq"].dtype == torch.bfloat16
    for a, b in zip(_leaves(t), _leaves(back)):
        assert torch.equal(a.to(b.dtype), b), (a, b)
    assert back["n"] is None and isinstance(back["opt"], opt.AdamWState)


@pytest.mark.parametrize("arch", ["granite-3-2b", "jamba-v0.1-52b"])
def test_jax_train_state_opens_in_the_port(tmp_path, arch):
    jcfg = jget_config(arch).smoke_config()
    jp = JT.init_params(jax.random.PRNGKey(1), jcfg)
    st = jopt.AdamWState(jnp.int32(9), jax.tree.map(lambda a: a * 0.5, jp),
                         jax.tree.map(lambda a: a * a, jp))
    jck.CheckpointManager(str(tmp_path)).save_train_state(9, jp, st)
    params, ostate, data_step = CheckpointManager(str(tmp_path)).restore_train_state(
        get_config(arch).smoke_config(), device=CPU)
    assert data_step == 9 and int(ostate.step) == 9 and ostate.step.dtype == torch.int32
    for mine, ref in ((params, jp), (ostate.m, st.m), (ostate.v, st.v)):
        want = {jax.tree_util.keystr(p): np.asarray(a)
                for p, a in jax.tree_util.tree_flatten_with_path(ref)[0]}
        for path, t in prm.leaf_paths(mine):
            assert np.array_equal(t.numpy(), want[path]), path


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen3-moe-30b-a3b"])
def test_port_train_state_opens_in_jax(tmp_path, arch):
    cfg = get_config(arch).smoke_config()
    params = _init(cfg)
    st = opt.AdamWState(torch.tensor(5, dtype=torch.int32),
                        prm.tree_map(lambda a: a * 0.5, params),
                        prm.tree_map(lambda a: a * a, params))
    CheckpointManager(str(tmp_path)).save_train_state(5, params, st)
    jp, jst, data_step = jck.CheckpointManager(str(tmp_path)).restore_train_state(
        jget_config(arch).smoke_config())
    assert data_step == 5 and int(jst.step) == 5
    for mine, ref in ((params, jp), (st.m, jst.m), (st.v, jst.v)):
        want = {jax.tree_util.keystr(p): np.asarray(a)
                for p, a in jax.tree_util.tree_flatten_with_path(ref)[0]}
        assert set(want) == {p for p, _ in prm.leaf_paths(mine)}
        for path, t in prm.leaf_paths(mine):
            assert np.array_equal(t.numpy(), want[path]), path
