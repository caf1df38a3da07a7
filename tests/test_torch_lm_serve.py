"""The port's LM serving path (`repro_torch.serve.engine.ServeEngine`,
`make_serve_step`, `make_prefill_step`, `models.transformer.prefill` /
`decode_step`) held against the JAX package's on the CPU.

`tests/test_serve.py` case for case, then: prefill caches and three
decode steps' caches equal to JAX's at f32 (1e-5 of each leaf's scale)
for every causal architecture, every cache leaf's dtype and shape equal to
JAX's at bf16, and `ServeEngine.generate`'s token ids equal to JAX's
`ServeEngine` at f32 (granite, paligemma with its vision prefix, xlstm
with its chunkwise prefill). Parameters are JAX's, converted with
`convert.model_params_from_numpy`; inputs come from numpy seeds.
"""
import dataclasses

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
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import params as tprm  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import (ServeEngine, make_prefill_step,  # noqa: E402
                               make_serve_step)
from repro_torch.utils import resolve_device  # noqa: E402

CAUSAL = [a for a in jconfigs.ARCH_IDS if jconfigs.get_config(a).has_decode]


def t_cfg(cfg):
    return tconfig.ModelConfig(**dataclasses.asdict(cfg))


def jax_model(arch, **replace):
    """(JAX cfg, JAX params, port cfg, port Transformer on the CPU) at the
    smoke config."""
    cfg = jconfigs.get_config(arch).smoke_config().replace(**replace)
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    tree = jax.tree.map(np.asarray, params)
    tcfg = t_cfg(cfg)
    return cfg, params, tcfg, convert.model_params_from_numpy(tcfg, tree, device="cpu")


def prompt(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        out["patches"] = rng.standard_normal(
            (B, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    return out


def to_t(inputs):
    return {k: torch.from_numpy(v) for k, v in inputs.items()}


@pytest.fixture(scope="module")
def engine():
    cfg = get_config("granite-3-2b").smoke_config()
    model = TT.Transformer(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    return cfg, model, ServeEngine(cfg, model, max_seq=64, device="cpu")


# ------------------------------------------------ test_serve.py's cases

def test_generate_shapes_and_determinism(engine):
    cfg, _, eng = engine
    toks = prompt(cfg, 2, 16, 1)
    out1 = eng.generate(toks, n_new=8)
    out2 = eng.generate(toks, n_new=8)
    assert out1.shape == (2, 8) and out1.dtype == torch.int32
    assert torch.equal(out1, out2)
    assert int(out1.max()) < cfg.vocab_padded


def test_generate_matches_stepwise_forward(engine):
    """Greedy engine output == argmax over repeated full forwards."""
    cfg, model, eng = engine
    toks = prompt(cfg, 1, 12, 2)["tokens"]
    out = eng.generate({"tokens": toks}, n_new=4).numpy()
    cur = toks
    with torch.no_grad():
        for i in range(4):
            x, _ = model({"tokens": torch.from_numpy(cur)})
            logits = TT.logits_from_hidden(model.param_tree(), x[:, -1:, :], cfg)
            nxt = int(torch.argmax(logits[0, -1]))
            assert nxt == out[0, i], f"step {i}: {nxt} vs {out[0, i]}"
            cur = np.concatenate([cur, [[nxt]]], axis=1).astype(np.int32)


def test_serve_step_moe_arch():
    cfg = get_config("qwen3-moe-30b-a3b").smoke_config()
    model = TT.Transformer(cfg, device="cpu")
    caches = tprm.tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype),
                           TT.cache_defs(cfg, 2, 32))
    step = make_serve_step(cfg)
    tok = torch.zeros((2, 1), dtype=torch.int32)
    with torch.no_grad():
        nxt, caches = step(model.param_tree(), tok, caches, 0)
        assert nxt.shape == (2, 1)
        nxt, _ = step(model.param_tree(), nxt, caches, 1)
    assert bool((nxt >= 0).all())


def test_generate_timings(engine):
    """`timings` receives the prefill's seconds and one entry a decode
    step; the ids are those of a run without it."""
    cfg, _, eng = engine
    toks = prompt(cfg, 2, 16, 9)
    t = {}
    out = eng.generate(toks, n_new=5, timings=t)
    assert set(t) == {"prefill_s", "step_s"} and len(t["step_s"]) == 4
    assert t["prefill_s"] > 0 and all(x > 0 for x in t["step_s"])
    assert torch.equal(out, eng.generate(toks, n_new=5))


# ------------------------------------------------------- against JAX

def _close(got, want, tol):
    """Within tol relative, and tol of the leaf's largest magnitude."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()))


def _leaves(caches):
    return {f"{k}.{name}": leaf for k, st in caches.items()
            for name, leaf in zip(st._fields, st)}


@pytest.mark.parametrize("arch", CAUSAL)
def test_prefill_and_decode_caches_match_jax(arch):
    """f32, no MoE drops: prefill's logits and caches, then three decode
    steps (the same tokens fed to both), each step's logits and every
    cache leaf equal to JAX's within 1e-5 of the leaf's scale. xlstm's
    recurrent states are held to 1e-4: there JAX's own f32 stabilizers
    (m) lie 1.2e-5–5.7e-5 from a float64 run of the port (the port's f32
    ones 3.7e-6–4.0e-5), so 1e-5 between the two is below f32's reach."""
    cfg, params, tcfg, model = jax_model(arch, compute_dtype="float32",
                                         capacity_factor=8.0)
    B, S = 2, 12
    prefix = cfg.n_prefix_embeds if cfg.frontend == "vision" else 0
    max_seq = S + prefix + 4
    inputs = prompt(cfg, B, S, 3)
    steps = np.random.default_rng(4).integers(0, cfg.vocab_size, (3, B, 1)).astype(np.int32)
    jl, jc = jax.jit(lambda p, i: JT.prefill(p, i, cfg, max_seq))(params, inputs)
    with torch.no_grad():
        tl, tc = model.prefill(to_t(inputs), max_seq)
    _close(tl, jl, 1e-5)
    state_tol = 1e-4 if arch == "xlstm-350m" else 1e-5
    jdec = jax.jit(lambda p, t, c, i: JT.decode_step(p, t, c, i, cfg))
    for i in range(4):
        jleaves, tleaves = _leaves(jc), _leaves(tc)
        assert jleaves.keys() == tleaves.keys()
        for name, want in jleaves.items():
            assert tuple(tleaves[name].shape) == want.shape, name
            _close(tleaves[name], want, state_tol)
        if i == 3:
            break
        index = S + prefix + i
        jl, jc = jdec(params, steps[i], jc, jnp.asarray(index, jnp.int32))
        with torch.no_grad():
            tl, tc = model.decode_step(torch.from_numpy(steps[i]), tc, index)
        _close(tl, jl, 1e-5)


@pytest.mark.parametrize("arch", CAUSAL)
def test_cache_dtypes_match_jax_at_bf16(arch):
    """Every cache leaf's dtype and shape equal JAX's (its `eval_shape`) at
    bf16, after prefill and after a decode step that writes them in place."""
    cfg, params, tcfg, model = jax_model(arch)
    B, S = 2, 8
    prefix = cfg.n_prefix_embeds if cfg.frontend == "vision" else 0
    max_seq = S + prefix + 2
    inputs = prompt(cfg, B, S, 5)
    _, jc = jax.eval_shape(lambda p, i: JT.prefill(p, i, cfg, max_seq), params, inputs)
    jdefs = JT.cache_defs(cfg, B, max_seq)
    tdefs = TT.cache_defs(tcfg, B, max_seq)
    with torch.no_grad():
        _, tc = model.prefill(to_t(inputs), max_seq)
        ptrs = {k: t.data_ptr() for k, t in _leaves(tc).items()}
        _, tc2 = model.decode_step(torch.zeros((B, 1), dtype=torch.int32), tc,
                                   S + prefix)
    assert tc2 is tc and {k: t.data_ptr() for k, t in _leaves(tc2).items()} == ptrs
    for defs in (_leaves(jc), _leaves(jdefs)):
        for name, want in defs.items():
            for got in (_leaves(tc)[name], _leaves(tdefs)[name]):
                assert str(got.dtype).removeprefix("torch.") == str(want.dtype), name
                assert tuple(got.shape) == tuple(want.shape), name


@pytest.mark.parametrize("arch,S,n_new", [("granite-3-2b", 12, 6),
                                          ("paligemma-3b", 12, 6),
                                          ("xlstm-350m", 128, 6)])
def test_serve_engine_tokens_match_jax(arch, S, n_new):
    """Greedy token ids equal JAX's ServeEngine at f32 (paligemma starts
    decoding after its patch prefix; xlstm's 128-token prompt takes the
    chunkwise mLSTM form in prefill)."""
    cfg, params, tcfg, model = jax_model(arch, compute_dtype="float32")
    inputs = prompt(cfg, 2, S, 6)
    max_seq = S + cfg.n_prefix_embeds + n_new
    want = np.asarray(JServeEngine(cfg, params, max_seq=max_seq).generate(
        {k: jnp.asarray(v) for k, v in inputs.items()}, n_new))
    got = ServeEngine(tcfg, model, max_seq=max_seq, device="cpu").generate(inputs, n_new)
    assert np.array_equal(got.numpy(), want)


def test_argmax_takes_the_first_maximum_over_the_padded_vocab():
    """A zero head ties every column: both engines pick id 0. A head that is
    zero but for one padded column (ones) picks that padded id wherever
    the hidden state sums above 0, as JAX's engine does."""
    cfg, params, tcfg, model = jax_model("granite-3-2b", compute_dtype="float32",
                                         vocab_size=250)
    inputs = prompt(cfg, 2, 8, 7)
    pad_id = cfg.vocab_size + 1
    assert pad_id < cfg.vocab_padded
    for col in (None, pad_id):
        w = np.zeros_like(np.asarray(params["head"]["w"]))
        if col is not None:
            w[:, col] = 1.0
        jp = dict(params, head={"w": jnp.asarray(w)})
        tree = model.param_tree()
        tp = dict(tree, head={"w": torch.from_numpy(w)})
        want = np.asarray(JServeEngine(cfg, jp, max_seq=12).generate(
            {"tokens": jnp.asarray(inputs["tokens"])}, 3))
        got = ServeEngine(tcfg, tp, max_seq=12, device="cpu").generate(inputs, 3).numpy()
        assert np.array_equal(got, want)
        if col is None:
            assert (got == 0).all()
        else:
            assert (got == pad_id).any() and set(np.unique(got)) <= {0, pad_id}


def test_make_prefill_step_is_prefill():
    cfg, _, tcfg, model = jax_model("granite-3-2b", compute_dtype="float32")
    inputs = to_t(prompt(cfg, 2, 8, 8))
    with torch.no_grad():
        a, ca = make_prefill_step(tcfg, 10)(model.param_tree(), inputs)
        b, cb = TT.prefill(model.param_tree(), inputs, tcfg, 10)
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(_leaves(ca).values(), _leaves(cb).values()))


def test_engine_casts_big_group_weights_once():
    """Leaves with ndim ≥ 3 and > 1e6 elements go to the compute dtype at
    construction (JAX's `_cast_big_params` rule); the rest stay f32."""
    cfg = get_config("granite-3-2b").smoke_config().replace(d_model=256, d_ff=1024)
    model = TT.Transformer(cfg, device="cpu")
    eng = ServeEngine(cfg, model, max_seq=16, device="cpu")
    for path, leaf in tprm.leaf_paths(eng.params):
        src = dict(tprm.leaf_paths(model.param_tree()))[path]
        big = path.startswith("['groups']") and src.dim() >= 3 and src.numel() > 1_000_000
        assert leaf.dtype == (torch.bfloat16 if big else torch.float32), path
        assert not leaf.requires_grad
    assert any(leaf.dtype == torch.bfloat16 for _, leaf in tprm.leaf_paths(eng.params))
    f32 = ServeEngine(cfg.replace(compute_dtype="float32"), model, max_seq=16, device="cpu")
    assert all(leaf.dtype == torch.float32 for _, leaf in tprm.leaf_paths(f32.params))


# ------------------------------------------------------------- refusals

def test_encoder_only_config_is_refused():
    """JAX's engine fails later, inside the decode step; the port refuses
    an encoder-only config when the engine is built."""
    cfg = get_config("hubert-xlarge").smoke_config()
    with pytest.raises(ValueError, match="encoder-only"):
        ServeEngine(cfg, TT.Transformer(cfg, device="cpu"), device="cpu")


@pytest.mark.parametrize("entry", ["Transformer", "init_params", "ServeEngine",
                                   "model_params_from_numpy"])
def test_entry_point_without_device_needs_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config("granite-3-2b").smoke_config()
    calls = {
        "Transformer": lambda: TT.Transformer(cfg),
        "init_params": lambda: TT.init_params(torch.Generator().manual_seed(0), cfg),
        "ServeEngine": lambda: ServeEngine(cfg, TT.Transformer(cfg, device="cpu")),
        "model_params_from_numpy": lambda: convert.model_params_from_numpy(
            cfg, tprm.tree_map(lambda t: t.numpy(),
                               TT.init_params(torch.Generator(), cfg, device="cpu"))),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_resolve_device_turns_off_reduced_precision_bf16_products():
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    resolve_device("cpu")
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_model_params_from_numpy_checks_the_tree():
    cfg = get_config("granite-3-2b").smoke_config()
    tree = tprm.tree_map(lambda t: t.numpy(),
                         TT.init_params(torch.Generator(), cfg, device="cpu"))
    bad = dict(tree, head={"w": tree["head"]["w"][:, :10]})
    with pytest.raises(ValueError, match="shape"):
        convert.model_params_from_numpy(cfg, bad, device="cpu")
    with pytest.raises(KeyError, match="missing"):
        convert.model_params_from_numpy(cfg, {k: v for k, v in tree.items() if k != "head"},
                                        device="cpu")
