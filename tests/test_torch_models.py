"""The port's LM models (`repro_torch.models`, `repro_torch.configs`) held
against the JAX package's on the CPU.

`tests/test_models_smoke.py` and `tests/test_mlstm_chunkwise.py` case for
case, at the smoke configs, on the same parameters (JAX's, converted with
`convert.model_params_from_numpy`) and the same inputs (numpy seeds):
configs and parameter counts equal; forward hidden state and loss at f32
within 1e-4, loss gradients within 1e-3 of `jax.grad`; bf16 logits within
2e-2 of the largest |logit|; the layers, blockwise attention, MoE routing
and the recurrent mixers one by one; the init rules. JAX's references are
computed once per module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import config as jconfig  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import params as jprm  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import model_params_from_numpy  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import params as tprm  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARCHS = jconfigs.ARCH_IDS
CAUSAL = [a for a in ARCHS if jconfigs.get_config(a).has_decode]
CPU = torch.device("cpu")


def np_batch(cfg, B=2, S=32, seed=1):
    """The JAX smoke tests' batch layout, drawn by numpy."""
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "audio":
        out["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        return out
    out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.frontend == "vision":
        out["patches"] = rng.standard_normal(
            (B, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    return out


def to_torch(tree):
    return tprm.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def t_cfg(cfg):
    """The port's copy of a JAX ModelConfig."""
    return tconfig.ModelConfig(**dataclasses.asdict(cfg))


class JaxRefs:
    """JAX's results for one smoke config, computed on first use."""

    def __init__(self):
        self._cache = {}

    def get(self, arch):
        if arch not in self._cache:
            cfg = jconfigs.get_config(arch).smoke_config().replace(
                compute_dtype="float32")
            params = JT.init_params(jax.random.PRNGKey(0), cfg)
            batch = np_batch(cfg)

            def f32(p, b):
                loss, grads = jax.value_and_grad(JT.loss_fn)(p, b, cfg)
                return loss, grads, JT.forward(p, b, cfg)[0]

            loss, grads, hidden = jax.jit(f32)(params, batch)
            cfg16 = cfg.replace(compute_dtype="bfloat16")
            logits16 = jax.jit(lambda p, b: JT.logits_from_hidden(
                p, JT.forward(p, b, cfg16)[0], cfg16))(params, batch)
            self._cache[arch] = dict(
                cfg=cfg, params=to_np(params), batch=batch, loss=float(loss),
                grads=to_np(grads), hidden=np.asarray(hidden),
                logits16=np.asarray(logits16.astype(jnp.float32)))
        return self._cache[arch]


@pytest.fixture(scope="module")
def refs():
    return JaxRefs()


def port_model(ref, **replace):
    cfg = t_cfg(ref["cfg"]).replace(**replace)
    return cfg, model_params_from_numpy(cfg, ref["params"], device="cpu")


def port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match_jax(arch):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for a, b in ((j, t), (j.smoke_config(), t.smoke_config())):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        for prop in ("hd", "cache_dtype", "n_groups", "has_decode", "d_inner",
                     "vocab_padded"):
            assert getattr(a, prop) == getattr(b, prop), prop
    assert tconfigs.get_rule_overrides(arch) == jconfigs.get_rule_overrides(arch)
    assert type(t).__module__ == "repro_torch.models.config"


def test_registry_shapes_and_skip_rules_match_jax():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")
    assert {k: dataclasses.asdict(v) for k, v in tconfig.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfig.SHAPES.items()}
    for arch in ARCHS:
        for name in jconfig.SHAPES:
            assert tconfig.cell_applicable(tconfigs.get_config(arch),
                                           tconfig.SHAPES[name]) == \
                jconfig.cell_applicable(jconfigs.get_config(arch),
                                        jconfig.SHAPES[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_exact_assigned_config_shapes(arch):
    """The FULL config's parameter tree: meta tensors (nothing allocated)
    with JAX's paths, shapes and exact count."""
    jshapes = {jax.tree_util.keystr(p): tuple(s.shape) for p, s in
               jax.tree_util.tree_flatten_with_path(
                   JT.abstract_params(jconfigs.get_config(arch)))[0]}
    tab = dict(tprm.leaf_paths(TT.abstract_params(tconfigs.get_config(arch))))
    assert all(t.device.type == "meta" and t.dtype == torch.float32
               for t in tab.values())
    assert {p: tuple(t.shape) for p, t in tab.items()} == jshapes
    assert sum(t.numel() for t in tab.values()) == \
        sum(int(np.prod(s)) for s in jshapes.values())


# ------------------------------------------------------ forward and grads

@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_and_grad(refs, arch):
    """f32: hidden state and loss within 1e-4, every gradient finite and
    within 1e-3 of jax.grad."""
    ref = refs.get(arch)
    cfg, model = port_model(ref)
    batch = port_batch(ref["batch"])
    x, _ = model(batch)
    S = ref["batch"]["labels"].shape[1] + (cfg.n_prefix_embeds
                                           if cfg.frontend == "vision" else 0)
    assert x.shape == (2, S, cfg.d_model)
    np.testing.assert_allclose(x.detach().numpy(), ref["hidden"], rtol=1e-4, atol=1e-4)
    loss = model.loss(batch)
    assert abs(float(loss) - ref["loss"]) <= 1e-4 * (1 + abs(ref["loss"]))
    paths, leaves = zip(*tprm.leaf_paths(model.param_tree()))
    grads = torch.autograd.grad(loss, leaves)
    want = dict(tprm.leaf_paths(ref["grads"]))
    for path, g in zip(paths, grads):
        assert bool(torch.isfinite(g).all()), (arch, path)
        np.testing.assert_allclose(g.numpy(), want[path], rtol=1e-3, atol=1e-3,
                                   err_msg=f"{arch} {path}")


def _departure(a, b, scale):
    """(max, median over positions) of |a − b| over the last axis, / scale."""
    err = np.abs(a - b).max(-1)
    return err.max() / scale, np.median(err) / scale


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_match_jax(refs, arch):
    """bf16 logits within 2e-2 of the largest |logit| of JAX's, where JAX's
    own bf16 logits stay that close to its f32 ones. At the smoke configs
    of qwen3-moe (an expert choice flips at a near tie), xlstm (the mLSTM's
    exp gates) and jamba (both), JAX's bf16 logits depart 20–90% of the
    largest |logit| from its own f32 ones, so two bf16 implementations
    cannot agree to 2e-2 there; the port's bf16 departure from the f32
    logits is then held to at most twice JAX's, and its blocks to 2e-2
    one by one (test_bf16_blocks_match_jax)."""
    ref = refs.get(arch)
    cfg, model = port_model(ref, compute_dtype="bfloat16")
    with torch.no_grad():
        x, _ = model(port_batch(ref["batch"]))
        logits = TT.logits_from_hidden(model.param_tree(), x, cfg)
    assert logits.dtype == torch.bfloat16
    got, want = logits.float().numpy(), ref["logits16"]
    scale = np.abs(want).max()
    f32 = ref["hidden"] @ ref["params"]["head"]["w"]
    jax_max, jax_med = _departure(want, f32, scale)
    if jax_max <= 2e-2:
        err = _departure(got, want, scale)[0]
        assert err <= 2e-2, (arch, err)
    else:
        port_max, port_med = _departure(got, f32, scale)
        assert port_max <= 2 * jax_max and port_med <= 2 * jax_med, \
            (arch, port_max, port_med, jax_max, jax_med)


def _bf16_block_case(kind):
    """(JAX fn, port fn, JAX params, cfg, bf16 input of unit rms) of one
    block at its arch's smoke config."""
    arch, S = {"attn": ("granite-3-2b", 32), "mlp": ("granite-3-2b", 32),
               "moe": ("qwen3-moe-30b-a3b", 32), "mamba": ("jamba-v0.1-52b", 32),
               "mlstm": ("xlstm-350m", 128), "mlstm_seq": ("xlstm-350m", 32),
               "slstm": ("xlstm-350m", 32)}[kind]
    cfg = jconfigs.get_config(arch).smoke_config()
    name = kind.split("_")[0]
    if name == "attn":
        defs, jfn, tfn = jattn.attn_def(cfg), None, None
    elif name == "mlp":
        defs = jlayers.mlp_def(cfg, cfg.d_ff)
        jfn, tfn = jlayers.mlp, tlayers.mlp
    elif name == "moe":
        defs, jfn, tfn = jmoe.moe_def(cfg), jmoe.moe_mlp, tmoe.moe_mlp
    else:
        defs = getattr(jssm, f"{name}_def")(cfg)
        jfn, tfn = getattr(jssm, f"{name}_block"), getattr(tssm, f"{name}_block")
    x = _unit_rms(_normal(8, 2, S, cfg.d_model))
    return name, cfg, _jax_leaves(defs), jnp.asarray(x, jnp.bfloat16), jfn, tfn


@pytest.mark.parametrize("kind", ["attn", "mlp", "moe", "mamba", "mlstm",
                                  "mlstm_seq", "slstm"])
def test_bf16_blocks_match_jax(kind):
    """Each block at bf16 on the same input: outputs (and states) within
    2e-2 of their largest magnitude; MoE routing ids equal."""
    name, cfg, p, xb, jfn, tfn = _bf16_block_case(kind)
    tp, tc = to_torch(to_np(p)), t_cfg(cfg)
    tx = torch.tensor(np.asarray(xb.astype(jnp.float32))).bfloat16()
    if name == "attn":
        pos = np.arange(xb.shape[1], dtype=np.int32)[None].repeat(2, 0)
        jout, jcache = jattn.attention_block(p, xb, pos, cfg)
        tout, tcache = tattn.attention_block(tp, tx, torch.from_numpy(pos), tc)
        want, got = (jout, *jcache), (tout, *tcache)
    elif name in ("mlp", "moe"):
        want, got = (jfn(p, xb, cfg),), (tfn(tp, tx, tc),)
        if name == "moe":
            xt = np.asarray(xb.astype(jnp.float32)).reshape(-1, cfg.d_model)
            _, je = jmoe._route(p["router"], xt, cfg.experts_per_token)
            _, te = tmoe._route(tp["router"], torch.from_numpy(xt), cfg.experts_per_token)
            assert np.array_equal(te.numpy(), np.asarray(je))
    else:
        jout, jst = jfn(p, xb, cfg)
        tout, tst = tfn(tp, tx, tc)
        want, got = (jout, *jst), (tout, *tst)
    for a, b in zip(got, want):
        assert a.dtype == getattr(torch, str(b.dtype))
        b = np.asarray(b.astype(jnp.float32))
        err = np.abs(a.float().numpy() - b).max()
        assert err <= 2e-2 * np.abs(b).max(), (kind, err, np.abs(b).max())


@pytest.mark.parametrize("arch", CAUSAL)
def test_prefill_decode_consistency(refs, arch):
    """decode_step after prefill reproduces the full forward's logits (f32,
    no MoE drops: capacity_factor 8)."""
    ref = refs.get(arch)
    cfg, model = port_model(ref, capacity_factor=8.0)
    B, S = 2, 16
    batch = port_batch(np_batch(cfg, B=B, S=S))
    with torch.no_grad():
        x, _ = model(batch)
        logits_full = TT.logits_from_hidden(model.param_tree(), x[:, -1:, :], cfg)
        prefix = cfg.n_prefix_embeds if cfg.frontend == "vision" else 0
        part = dict(batch, tokens=batch["tokens"][:, :S - 1])
        _, caches = model.prefill(part, max_seq=S + prefix)
        logits_dec, _ = model.decode_step(batch["tokens"][:, S - 1:S], caches,
                                          S - 1 + prefix)
    np.testing.assert_allclose(logits_dec.numpy(), logits_full.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_moe_capacity_drop_keeps_output_finite(refs):
    ref = refs.get("qwen3-moe-30b-a3b")
    _, model = port_model(ref, capacity_factor=0.5, compute_dtype="bfloat16")
    with torch.no_grad():
        assert bool(torch.isfinite(model.loss(port_batch(ref["batch"]))))


def test_remat_matches_no_remat(refs):
    """Without autograd recording, `remat` changes nothing: the groups run
    under torch.utils.checkpoint only where gradients are recorded
    (test_torch_train.py holds the recorded case)."""
    ref = refs.get("granite-3-2b")
    cfg, model = port_model(ref, compute_dtype="bfloat16")
    batch = port_batch(ref["batch"])
    with torch.no_grad():
        l1 = TT.loss_fn(model.param_tree(), batch, cfg)
        l2 = TT.loss_fn(model.param_tree(), batch, cfg.replace(remat="none"))
    assert float(l1) == float(l2)


# ------------------------------------------------------------- layers

def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("mode", ["full", "causal", "prefix"])
@pytest.mark.parametrize("S", [16, 64])
def test_blockwise_attention_matches_jax(mode, S):
    """S = 16: the single tile; S = 64: the online-softmax loop over 4 × 4
    chunks of 16."""
    B, h, hd = 2, 4, 16
    q, k, v = (_normal(i, B, S, h, hd) for i in range(3))
    want = jattn.blockwise_attention(*map(jnp.asarray, (q, k, v)), mode, 8,
                                     q_chunk=16, kv_chunk=16)
    got = tattn.blockwise_attention(*map(torch.from_numpy, (q, k, v)), mode, 8,
                                    q_chunk=16, kv_chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_blockwise_attention_bf16_matches_jax():
    B, S, h, hd = 2, 64, 4, 16
    q, k, v = (_normal(i, B, S, h, hd) for i in range(3))
    want = jattn.blockwise_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                     "causal", 0, q_chunk=16, kv_chunk=16)
    got = tattn.blockwise_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                                    "causal", 0, q_chunk=16, kv_chunk=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_expand_kv_order_matches_jax():
    k = np.arange(2 * 3 * 2 * 4, dtype=np.float32).reshape(2, 3, 2, 4)
    assert np.array_equal(tattn._expand_kv(torch.from_numpy(k), 8).numpy(),
                          np.asarray(jattn._expand_kv(k, 8)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_and_rmsnorm_match_jax(dtype):
    x = _normal(0, 2, 16, 4, 32)
    pos = (np.arange(16, dtype=np.int32) * 257)[None].repeat(2, 0)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(tlayers.DTYPES[dtype])
    tol = 1e-5 if dtype == "float32" else 1e-2
    want = np.asarray(jlayers.rope(jx, pos, 10_000.0), np.float32)
    got = tlayers.rope(tx, torch.from_numpy(pos), 10_000.0)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    scale = _normal(1, 32) + 1.0
    want = np.asarray(jlayers.rmsnorm({"scale": scale}, jx, 1e-6), np.float32)
    got = tlayers.rmsnorm({"scale": torch.from_numpy(scale)}, tx, 1e-6)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def _jax_leaves(defs, seed=0):
    return jprm.init(jax.random.PRNGKey(seed), defs)


@pytest.mark.parametrize("flavour", ["swiglu", "geglu", "squared_relu", "gelu"])
def test_mlp_matches_jax(flavour):
    """geglu and gelu take GELU's tanh form, as jax.nn.gelu does."""
    cfg = jconfigs.get_config("granite-3-2b").smoke_config().replace(
        mlp=flavour, compute_dtype="float32")
    p = _jax_leaves(jlayers.mlp_def(cfg, 128))
    x = _normal(2, 2, 8, cfg.d_model)
    want = jlayers.mlp(p, x, cfg)
    got = tlayers.mlp(to_torch(to_np(p)), torch.from_numpy(x), t_cfg(cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_gelu_is_the_tanh_form():
    x = torch.linspace(-4, 4, 101)
    assert torch.equal(tlayers.gelu(x), torch.nn.functional.gelu(x, approximate="tanh"))
    assert not torch.equal(tlayers.gelu(x), torch.nn.functional.gelu(x))


# ----------------------------------------------------------------- MoE

def _moe_case(cf):
    cfg = jconfigs.get_config("qwen3-moe-30b-a3b").smoke_config().replace(
        capacity_factor=cf, compute_dtype="float32")
    p = _jax_leaves(jmoe.moe_def(cfg))
    x = _normal(3, 2, 16, cfg.d_model)
    return cfg, p, x


@pytest.mark.parametrize("cf", [0.5, 8.0])
def test_moe_routing_and_mlp_match_jax(cf):
    """Routing ids equal, gates close; the MoE MLP within 1e-5 with drops
    (capacity_factor 0.5) and without (8)."""
    cfg, p, x = _moe_case(cf)
    tp = to_torch(to_np(p))
    xt = x.reshape(-1, cfg.d_model)
    jg, je = jmoe._route(p["router"], xt, cfg.experts_per_token)
    tg, te = tmoe._route(tp["router"], torch.from_numpy(xt), cfg.experts_per_token)
    assert np.array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-6)
    want = jmoe.moe_mlp(p, x, cfg)
    got = tmoe.moe_mlp(tp, torch.from_numpy(x), t_cfg(cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_moe_routing_ties_go_to_the_lower_expert():
    router = torch.zeros(4, 6)
    gates, eidx = tmoe._route(router, torch.ones(3, 4), 2)
    assert eidx.tolist() == [[0, 1]] * 3
    jg, je = jmoe._route(np.zeros((4, 6), np.float32), np.ones((3, 4), np.float32), 2)
    assert np.array_equal(eidx.numpy(), np.asarray(je))


def test_moe_aux_loss_matches_jax():
    cfg, p, x = _moe_case(1.25)
    want = float(jmoe.moe_aux_loss(p, x, cfg))
    got = float(tmoe.moe_aux_loss(to_torch(to_np(p)), torch.from_numpy(x), t_cfg(cfg)))
    assert abs(got - want) <= 1e-5 * abs(want)


# ------------------------------------------------------------- mLSTM

def _mlstm_inputs(seed, B, S, H, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)) * hd ** -0.5
    k = rng.standard_normal((B, S, H, hd)) * hd ** -0.5
    v = rng.standard_normal((B, S, H, hd))
    ig = rng.standard_normal((B, S, H)) * 2.0
    fg = rng.standard_normal((B, S, H)) * 2.0 + 1.0
    return [a.astype(np.float32) for a in (q, k, v, ig, fg)]


def _zero_state(B, H, hd):
    return (torch.zeros(B, H, hd, hd), torch.zeros(B, H, hd),
            torch.full((B, H), -1e30))


@pytest.mark.parametrize("S", [128, 256])
def test_chunkwise_matches_sequential(S):
    B, H, hd = 2, 3, 16
    ins = [torch.from_numpy(a) for a in _mlstm_inputs(0, B, S, H, hd)]
    h_seq, (C1, n1, m1) = tssm._mlstm_sequential(*ins, *_zero_state(B, H, hd), S)
    h_chk, (C2, n2, m2) = tssm._mlstm_chunkwise(*ins, *_zero_state(B, H, hd), S)
    np.testing.assert_allclose(h_chk.numpy(), h_seq.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(m2.numpy(), m1.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(C2.numpy(), C1.numpy(), rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(n2.numpy(), n1.numpy(), rtol=2e-3, atol=2e-4)


def test_chunkwise_with_nonzero_initial_state():
    B, H, hd, S = 1, 2, 8, 128
    ins = [torch.from_numpy(a) for a in _mlstm_inputs(1, B, S, H, hd)]
    st = (torch.from_numpy(_normal(2, B, H, hd, hd, scale=0.5)),
          torch.from_numpy(_normal(3, B, H, hd, scale=0.5)), torch.zeros(B, H))
    h_seq, _ = tssm._mlstm_sequential(*ins, *st, S)
    h_chk, _ = tssm._mlstm_chunkwise(*ins, *st, S)
    np.testing.assert_allclose(h_chk.numpy(), h_seq.numpy(), rtol=2e-4, atol=2e-4)


def test_state_handoff_chunked_to_sequential():
    """prefill (chunkwise) → decode (sequential single step) consistency."""
    B, H, hd, S = 1, 2, 8, 128
    ins = [torch.from_numpy(a) for a in _mlstm_inputs(3, B, S + 1, H, hd)]
    h_all, _ = tssm._mlstm_sequential(*ins, *_zero_state(B, H, hd), S + 1)
    _, st = tssm._mlstm_chunkwise(*(t[:, :S] for t in ins), *_zero_state(B, H, hd), S)
    h_last, _ = tssm._mlstm_sequential(*(t[:, S:] for t in ins), *st, 1)
    np.testing.assert_allclose(h_last[:, 0].numpy(), h_all[:, S].numpy(),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("form", ["chunkwise", "sequential"])
def test_mlstm_forms_match_jax(form):
    B, H, hd, S = 2, 3, 16, 128
    ins = _mlstm_inputs(4, B, S, H, hd)
    st = (_normal(5, B, H, hd, hd, scale=0.5), _normal(6, B, H, hd, scale=0.5),
          np.zeros((B, H), np.float32))
    jfn = getattr(jssm, f"_mlstm_{form}")
    tfn = getattr(tssm, f"_mlstm_{form}")
    hj, sj = jfn(*ins, *st, S)
    ht, stt = tfn(*map(torch.from_numpy, ins), *map(torch.from_numpy, st), S)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=2e-4, atol=2e-4)
    for a, b in zip(stt, sj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-4)


# ------------------------------------------------- blocks with states

def _unit_rms(x):
    """x scaled to unit rms over its last axis, as rmsnorm hands a block
    its input."""
    return (x / np.sqrt((x * x).mean(-1, keepdims=True))).astype(np.float32)


def _block_case(arch, kind, S):
    cfg = jconfigs.get_config(arch).smoke_config().replace(compute_dtype="float32")
    p = _jax_leaves(getattr(jssm, f"{kind}_def")(cfg))
    return cfg, p, _unit_rms(_normal(7, 2, S, cfg.d_model))


@pytest.mark.parametrize("arch,kind,S", [("jamba-v0.1-52b", "mamba", 16),
                                         ("xlstm-350m", "slstm", 16),
                                         ("xlstm-350m", "mlstm", 128)])
def test_block_with_carried_state_matches_jax(arch, kind, S):
    """The whole sequence, then its two halves with the state carried (the
    mLSTM halves take the sequential form, the whole the chunkwise one):
    outputs and states equal JAX's (1e-4; the mLSTM 2e-4), and the halves
    equal the whole. The absolute part of the tolerance scales with the
    tensor's largest magnitude: the random-init Mamba block's outputs reach
    thousands, and its small entries carry cancellation errors of ~1e-6 of
    that in both packages alike (each as far from a float64 run)."""
    cfg, p, x = _block_case(arch, kind, S)
    tol = 2e-4 if kind == "mlstm" else 1e-4
    jblock, tblock = getattr(jssm, f"{kind}_block"), getattr(tssm, f"{kind}_block")
    tp, tc = to_torch(to_np(p)), t_cfg(cfg)
    h = S // 2
    jfull, jst = jblock(p, x, cfg)
    j1, jst1 = jblock(p, x[:, :h], cfg)
    j2, jst2 = jblock(p, x[:, h:], cfg, jst1)
    tx = torch.from_numpy(x)
    tfull, tst = tblock(tp, tx, tc)
    t1, tst1 = tblock(tp, tx[:, :h], tc)
    t2, tst2 = tblock(tp, tx[:, h:], tc, tst1)

    def close(a, b, tol):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=tol,
                                   atol=tol * max(1.0, np.abs(b).max()))

    for got, want in ((tfull, jfull), (t1, j1), (t2, j2)):
        close(got, want, tol)
    for got_st, want_st in ((tst, jst), (tst2, jst2)):
        assert type(got_st).__name__ == type(want_st).__name__
        for a, b in zip(got_st, want_st):
            assert a.dtype == getattr(torch, str(b.dtype))
            close(a, b, tol)
    close(torch.cat([t1, t2], 1), tfull.numpy(), 2e-4)


# ------------------------------------------------------------- init

@pytest.mark.parametrize("arch", ARCHS)
def test_init_rules_match_jax(arch):
    """zeros / ones / ssm_a leaves equal JAX's; each normal leaf's std within
    10% of JAX's (at d_model 256, so every leaf holds ≥ 2,048 draws), the
    same draws each time from one seed."""
    jcfg = jconfigs.get_config(arch).smoke_config().replace(d_model=256)
    jdefs = JT.model_defs(jcfg)
    jp = dict(tprm.leaf_paths(to_np(JT.init_params(jax.random.PRNGKey(0), jcfg))))
    tcfg = t_cfg(jcfg)
    tp = dict(tprm.leaf_paths(TT.init_params(torch.Generator().manual_seed(0), tcfg,
                                             device="cpu")))
    again = dict(tprm.leaf_paths(TT.init_params(torch.Generator().manual_seed(0), tcfg,
                                                device="cpu")))
    defs = dict(tprm.leaf_paths(jdefs))
    assert set(tp) == set(jp) == set(defs)
    for path, d in defs.items():
        assert torch.equal(tp[path], again[path]), path
        a, b = tp[path].numpy(), jp[path]
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if d.init == "normal":
            assert a.size >= 2048, path
            assert abs(a.std() / b.std() - 1) < 0.1, (path, a.std(), b.std())
        else:
            assert np.array_equal(a, b), (path, d.init)
