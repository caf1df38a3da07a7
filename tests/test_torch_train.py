"""The port's training path (`repro_torch.train`: optimizer, train step and
loop; the remat of `models/transformer.py`) held against the JAX package
on the CPU.

`tests/test_train_loop.py` case for case on the port, then the port
against JAX on the same numpy inputs: `update` and `warmup_cosine` on
random trees, one and three `make_train_step` steps of the tiny config
in f32 from JAX's parameters (carried by `convert.train_state_from_numpy`)
against `jax.jit(make_train_step)` — loss, every parameter and every m / v
leaf — and `remat="block"` against `"none"` bit for bit. Tolerances are
stated at each check.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.train_loop import make_train_step as jmake_train_step  # noqa: E402

from repro_torch.ckpt.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import train_state_from_numpy  # noqa: E402
from repro_torch.data.pipeline import for_model  # noqa: E402
from repro_torch.models import params as prm  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.train_loop import (Watchdog, _grad_leaves,  # noqa: E402
                                          make_train_step, train)

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


def _tiny(get=get_config, **kw):
    return get("granite-3-2b").smoke_config().replace(
        n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab_size=64, **kw)


def _init(cfg, seed=0):
    return T.init_params(torch.Generator().manual_seed(seed), cfg, device=CPU)


def _clone(tree):
    return prm.tree_map(lambda a: a.clone(), tree)


# ------------------------------------------ tests/test_train_loop.py, case for case

def test_loss_decreases():
    cfg = _tiny()
    pipe = for_model(cfg, seq_len=32, global_batch=8, mode="markov")
    _, _, losses = train(cfg, pipe, steps=30, lr=3e-3, log_every=1000, device=CPU)
    first = np.mean(losses[:5])
    last = np.mean(losses[-5:])
    assert last < first - 0.2, (first, last)


def test_grad_accum_matches_full_batch():
    """JAX's bars: loss rtol 2e-4; parameters rtol 6e-3, atol 5e-4 (bf16
    accumulation noise through Adam's rsqrt on near-zero second moments)."""
    cfg = _tiny()
    pipe = for_model(cfg, seq_len=16, global_batch=8)
    params = _init(cfg)
    lr_fn = opt.warmup_cosine(1e-3, 5, 100)
    batch = pipe.batch_at(0)
    p1, _, m1 = make_train_step(cfg, lr_fn, accum=1)(_clone(params), opt.init(params), batch)
    p4, _, m4 = make_train_step(cfg, lr_fn, accum=4)(_clone(params), opt.init(params), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]), rtol=2e-4)
    for (_, a), (_, b) in zip(prm.leaf_paths(p1), prm.leaf_paths(p4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=6e-3, atol=5e-4)


def test_resume_from_checkpoint(tmp_path):
    cfg = _tiny()
    pipe = for_model(cfg, seq_len=16, global_batch=4)
    m = CheckpointManager(str(tmp_path))
    train(cfg, pipe, steps=6, ckpt_manager=m, ckpt_every=3, log_every=1000, device=CPU)
    assert m.latest_step() == 6
    # resuming continues from saved step without error
    _, _, losses = train(cfg, pipe, steps=8, ckpt_manager=m, ckpt_every=100,
                         log_every=1000, device=CPU)
    assert len(losses) == 2   # only steps 6,7 run


def test_optimizer_clipping():
    params = {"w": torch.ones(4)}
    grads = {"w": torch.full((4,), 1e6)}
    st = opt.init(params)
    _, _, metrics = opt.update(grads, st, params, lambda s: torch.tensor(1e-3),
                               clip_norm=1.0)
    assert float(metrics["grad_norm"]) > 1e5   # reported pre-clip


# -------------------------------------------------------------- against JAX

def _np_tree(seed, shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(rng.standard_normal(s) * scale, dtype=np.float32)
            for k, s in shapes.items()}


SHAPES = {"a": (3, 5), "b": (7,), "c": (2, 2, 4), "d": ()}


@pytest.mark.parametrize("gscale,step", [(0.01, 0), (0.01, 7), (50.0, 3)])
def test_update_matches_jax(gscale, step):
    """One AdamW update on random trees (gscale 50: the clip is active)
    from a random state: params, m and v within rtol 1e-6 / atol 1e-7,
    grad_norm and lr within rtol 1e-6."""
    p, g = _np_tree(0, SHAPES), _np_tree(1, SHAPES, gscale)
    m, v = _np_tree(2, SHAPES, 0.1), {k: np.asarray(np.abs(a)) for k, a in _np_tree(3, SHAPES, 0.01).items()}
    jlr, tlr = jopt.warmup_cosine(1e-3, 5, 20), opt.warmup_cosine(1e-3, 5, 20)
    jp, js, jm = jax.jit(lambda *a: jopt.update(*a, jlr))(
        g, jopt.AdamWState(jnp.int32(step), m, v), p)
    t = {k: {n: torch.from_numpy(np.array(a)) for n, a in tree.items()}
         for k, tree in dict(p=p, g=g, m=m, v=v).items()}
    tp, ts, tm = opt.update(t["g"], opt.AdamWState(torch.tensor(step, dtype=torch.int32),
                                                   t["m"], t["v"]), t["p"], tlr)
    assert int(ts.step) == int(js.step) == step + 1 and ts.step.dtype == torch.int32
    for mine, ref in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        for k in SHAPES:
            np.testing.assert_allclose(mine[k].numpy(), np.asarray(ref[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6)


@pytest.mark.parametrize("warmup,total", [(10, 100), (5, 20), (0, 7), (30, 30)])
def test_warmup_cosine_matches_jax(warmup, total):
    """Every step of the schedule (and past its end) within rtol 1e-6 (a few
    ulp) of JAX's f32 values: the same operations in the same order, but
    cos differs in its last bit between implementations (JAX's own
    vectorised and scalar compilations differ there too)."""
    jf, tf = jopt.warmup_cosine(3e-4, warmup, total), opt.warmup_cosine(3e-4, warmup, total)
    steps = np.arange(total + 5, dtype=np.int32)
    want = np.asarray(jax.vmap(jf)(jnp.asarray(steps)))
    got = tf(torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_global_norm_matches_jax_on_chunked_leaves(monkeypatch):
    """A leaf longer than the update's chunk is summed chunk by chunk:
    rtol 1e-6 of JAX's norm."""
    monkeypatch.setattr(opt, "CHUNK", 64)
    tree = _np_tree(4, {"x": (33, 7), "y": (5,)})
    got = opt.global_norm({k: torch.from_numpy(a) for k, a in tree.items()})
    np.testing.assert_allclose(float(got), float(jopt.global_norm(tree)), rtol=1e-6)


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's tiny config (f32 compute) from PRNGKey(0): three jitted steps
    (accum 1) and one at accum 4, on numpy batches."""
    cfg = _tiny(jget_config, compute_dtype="float32")
    params = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(5)
    batches = [{"tokens": rng.integers(0, 64, (8, 16)).astype(np.int32),
                "labels": rng.integers(0, 64, (8, 16)).astype(np.int32)} for _ in range(3)]
    lr_fn = jopt.warmup_cosine(1e-3, 2, 10)
    out = {"params": params, "batches": batches}
    for accum, n in ((1, 3), (4, 1)):
        step = jax.jit(jmake_train_step(cfg, lr_fn, accum=accum))
        p, s, hist = params, jopt.init(params), []
        for b in batches[:n]:
            p, s, m = step(p, s, b)
            hist.append((jax.tree.map(np.asarray, (p, s)), float(m["loss"]),
                         float(m["grad_norm"]), float(m["lr"])))
        out[accum] = hist
    return out


@pytest.mark.parametrize("accum,n_steps", [(1, 1), (1, 3), (4, 1)])
def test_train_step_matches_jax(jax_steps, accum, n_steps):
    """The port's step on JAX's parameters and batches (f32): loss and
    grad_norm within rtol 1e-5, lr equal; every parameter, m and v leaf
    within rtol 1e-4 / atol 2e-6 (Adam divides by √v̂ + 1e-8, so a
    gradient's last-bit difference shows most where it is tiny)."""
    cfg = _tiny(compute_dtype="float32")
    params, state = train_state_from_numpy(
        cfg, jax_steps["params"], jopt.init(jax_steps["params"]), device=CPU)
    step = make_train_step(cfg, opt.warmup_cosine(1e-3, 2, 10), accum=accum)
    for i in range(n_steps):
        batch = {k: torch.from_numpy(v) for k, v in jax_steps["batches"][i].items()}
        params, state, m = step(params, state, batch)
        (jp, js), jloss, jgn, jlr = jax_steps[accum][i]
        np.testing.assert_allclose(float(m["loss"]), jloss, rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), jgn, rtol=1e-5)
        assert float(m["lr"]) == jlr
        assert int(state.step) == int(js.step) == i + 1
        for mine, ref in ((params, jp), (state.m, js.m), (state.v, js.v)):
            want = dict(prm.leaf_paths(ref))
            for path, t in prm.leaf_paths(mine):
                np.testing.assert_allclose(t.numpy(), want[path], rtol=1e-4, atol=2e-6,
                                           err_msg=f"step {i} {path}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_block_equals_none_bitwise(dtype):
    """Loss and every gradient with each group under torch.utils.checkpoint
    equal to the plain graph's, bit for bit (the recompute runs the same
    operations)."""
    out = []
    for remat in ("block", "none"):
        cfg = _tiny(compute_dtype=dtype, remat=remat)
        params = prm.tree_map(lambda a: a.requires_grad_(), _init(cfg))
        batch = for_model(cfg, seq_len=16, global_batch=4).batch_at(0)
        loss = T.loss_fn(params, batch, cfg)
        leaves = [t for _, t in prm.leaf_paths(params)]
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_remat_wraps_each_group_only_under_grad(monkeypatch):
    calls = []
    real = T.checkpoint
    monkeypatch.setattr(T, "checkpoint", lambda *a, **k: calls.append(k) or real(*a, **k))
    cfg = _tiny()
    params = _init(cfg)
    batch = for_model(cfg, seq_len=16, global_batch=2).batch_at(0)
    with torch.no_grad():
        T.loss_fn(params, batch, cfg)
    assert calls == []
    T.loss_fn(params, batch, cfg)
    assert calls == [{"use_reentrant": False}] * cfg.n_groups
    T.loss_fn(params, batch, cfg.replace(remat="none"))
    assert len(calls) == cfg.n_groups


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen3-moe-30b-a3b", "jamba-v0.1-52b"])
def test_grad_leaves_accumulate_the_stacked_gradient(arch):
    """The trainer's leaves (one autograd leaf a group slice, accumulating
    into the step's gradient tree in place) give the stacked leaves'
    gradients bit for bit, twice accumulated exactly twice."""
    cfg = get_config(arch).smoke_config().replace(compute_dtype="float32")
    params = _init(cfg)
    batch = for_model(cfg, seq_len=16, global_batch=2).batch_at(0)
    stacked = prm.tree_map(lambda a: a.detach().requires_grad_(), params)
    paths, leaves = zip(*prm.leaf_paths(stacked))
    want = torch.autograd.grad(T.loss_fn(stacked, batch, cfg), leaves)
    grads = prm.tree_map(torch.zeros_like, params)
    for n in (1, 2):
        T.loss_fn(_grad_leaves(params, grads, cfg.n_groups), batch, cfg).backward()
        got = dict(prm.leaf_paths(grads))
        for path, w in zip(paths, want):
            assert torch.equal(got[path], n * w), (n, path)


def test_train_updates_caller_params_in_place_and_stays_on_cpu():
    """The step updates the tensors it is given (JAX donates them); a run
    with device="cpu" never leaves the CPU."""
    cfg = _tiny()
    params = _init(cfg)
    ptr = params["embed"]["table"].data_ptr()
    before = params["embed"]["table"].clone()
    out, state, _ = train(cfg, for_model(cfg, seq_len=16, global_batch=2), steps=2,
                          params=params, log_every=1000, device=CPU)
    assert out["embed"]["table"].data_ptr() == ptr
    assert not torch.equal(out["embed"]["table"], before)
    assert all(t.device.type == "cpu" for _, t in prm.leaf_paths(state.m))


def test_watchdog_flags_a_straggler():
    seen = []
    wd = Watchdog(factor=3.0, warn=seen.append)
    for i, dt in enumerate([1.0, 1.1, 0.9, 1.0, 1.2, 1.0, 5.0]):
        wd.observe(dt, i)
    assert len(seen) == 1 and "step 6" in seen[0]
