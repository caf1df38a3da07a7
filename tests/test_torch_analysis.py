"""The port's static contract analyzer (repro_torch.analysis) against the
JAX package's (repro.analysis) on the same inputs.

- Findings and baselines: one finding has one fingerprint in both
  packages, and each package reads the other's baseline file.
- AST lints: both `lint_source`s give the same findings (rule, line,
  context, snippet) on the JAX package's own snippets, each under its
  package's path prefix; the port's library lints clean.
- Contracts: the synthetic cases of tests/test_analysis.py through both
  checkers (JAX's f64 case under `jax.enable_x64(True)`), the host-sync
  rule, the 11 registered contracts at N_TRACE = 16,411 on the CPU, the
  candidate-local pin of tests/test_search_pipeline.py on the port's
  `search_jit`, and each rule the port states in place of JAX's.
- The CLI with `--device cpu`: 0 on the repo, nonzero for every
  injected class.

The contracts' fixtures are built once per process (`_tiny_index` is
cached); tests/test_torch_cuda.py runs the CLI on the card.
"""
import json
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.analysis import contracts as jax_contracts  # noqa: E402
from repro.analysis import findings as jax_findings  # noqa: E402
from repro.analysis import lint_ast as jax_lint  # noqa: E402

from repro_torch.analysis import check, contracts, findings, lint_ast  # noqa: E402

N = 257  # prime, as in the real contracts
ROOT_PREFIX = {"jax": "src/repro/", "port": "src/repro_torch/"}


def _port(build, **rules):
    """Register `build` (device → TraceSpec) in a throwaway registry of
    the port, return its findings on the CPU."""
    reg = {}
    contracts.jaxpr_contract("probe", registry=reg, **rules)(build)
    return contracts.check_contract(reg["probe"], "cpu")


def _jax(build, **rules):
    reg = {}
    jax_contracts.jaxpr_contract("probe", registry=reg, **rules)(build)
    return jax_contracts.check_contract(reg["probe"])


def _keys(found):
    return sorted((f.rule, f.snippet) for f in found)


# ------------------------------------------------------ findings, baseline

FINDINGS = [
    dict(rule="falsy-int-default", path="src/repro/x.py", message="m",
         line=10, context="f", snippet="a or 1"),
    dict(rule="jaxpr-dim", path="contract:search_jit", message="m",
         context="search_jit", snippet="n=3001:[(3001,)]"),
    dict(rule="lock-discipline", path="src/repro_torch/serve/x.py",
         message="other words", line=3),
]


@pytest.mark.parametrize("kw", FINDINGS, ids=lambda kw: kw["rule"])
def test_fingerprint_and_record_equal_jax(kw):
    a, b = findings.Finding(**kw), jax_findings.Finding(**kw)
    assert a.fingerprint == b.fingerprint
    assert a.to_dict() == b.to_dict()
    assert a.render() == b.render()
    assert a.render(grandfathered=True) == b.render(grandfathered=True)
    # the line is display only, as in JAX
    moved = findings.Finding(**{**kw, "line": 99})
    assert moved.fingerprint == a.fingerprint


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_baselines_read_across_packages(tmp_path, writer):
    port = [findings.Finding(**kw) for kw in FINDINGS]
    jx = [jax_findings.Finding(**kw) for kw in FINDINGS]
    path = str(tmp_path / "baseline.json")
    if writer == "jax":
        jax_findings.save_baseline(jx[:2], path)
    else:
        findings.save_baseline(port[:2], path)
    text = open(path).read()
    other = str(tmp_path / "other.json")
    (jax_findings.save_baseline(jx[:2], other) if writer == "port"
     else findings.save_baseline(port[:2], other))
    assert open(other).read() == text          # byte-identical files
    for pkg, fs in ((findings, port), (jax_findings, jx)):
        bl = pkg.load_baseline(path)
        new, old = pkg.partition_findings(fs, bl)
        assert old == fs[:2] and new == fs[2:]


def test_committed_baselines_are_empty_and_alike():
    a = findings.load_baseline()
    b = jax_findings.load_baseline()
    assert a.fingerprints == b.fingerprints == set()
    assert findings.BASELINE_PATH != jax_findings.BASELINE_PATH
    assert open(findings.BASELINE_PATH).read() == open(jax_findings.BASELINE_PATH).read()


def test_missing_baseline_blocks_everything(tmp_path):
    bl = findings.load_baseline(str(tmp_path / "missing.json"))
    f = findings.Finding("lock-discipline", "src/repro_torch/serve/x.py", "m")
    new, old = findings.partition_findings([f], bl)
    assert new == [f] and old == []


# ---------------------------------------------------------------- AST lints
# The JAX package's snippets (tests/test_analysis.py), each with the
# package subdirectory it is linted under.

LINT_CASES = {
    "unlocked-bad": ("serve", """\
        class F:
            def poll(self):
                self._expire_locked()
    """),
    "unlocked-ok": ("serve", """\
        class F:
            def poll(self):
                with self._cond:
                    self._expire_locked()

            def _admit_locked(self):
                self._expire_locked()   # caller holds the lock
    """),
    "falsy-attr": ("core", "def f(self, top_t=None):\n    return top_t or self.top_t\n"),
    "falsy-call": ("core", "def f(c=None, n=0):\n    return c or max(4, n // 256)\n"),
    "falsy-sentinel": ("core", "def f(self, top_t=None):\n"
                               "    return self.top_t if top_t is None else top_t\n"),
    "falsy-string": ("core", "def f(name=None):\n    return name or 'default'\n"),
    "np-random-bad": ("core", "import numpy as np\nx = np.random.randint(0, 4)\n"),
    "np-random-ok": ("core", "import numpy as np\nrng = np.random.default_rng(0)\n"),
    "pickle-import": ("ckpt", "import pickle\n"),
    "pickle-allow": ("ckpt", "import numpy as np\n"
                             "x = np.load('f.npy', allow_pickle=True)\n"),
    "pickle-outside": ("core", "import pickle\n"),
    "validate-ok": ("serve", """\
        class Engine:
            def search(self, Q):
                return self.search_request(Q)

            def search_request(self, Q, params=None):
                p = (params or SearchParams()).validate()
                return p
    """),
    "validate-bad": ("serve", """\
        class Engine:
            def search(self, Q, k=10):
                return self._go(Q, k)

            def _go(self, Q, k):
                return Q[:k]
    """),
    "outside-library": ("../tests", "import pickle\nx = np.random.rand()\n"),
}


def _lint(pkg, src, sub):
    rel = ROOT_PREFIX[pkg] + f"{sub}/_synthetic.py"
    rel = rel.replace("src/repro/../", "").replace("src/repro_torch/../", "")
    mod = jax_lint if pkg == "jax" else lint_ast
    return mod.lint_source(textwrap.dedent(src), rel)


@pytest.mark.parametrize("case", sorted(LINT_CASES))
def test_lint_rules_match_jax(case):
    sub, src = LINT_CASES[case]
    got = [(f.rule, f.line, f.context, f.snippet) for f in _lint("port", src, sub)]
    want = [(f.rule, f.line, f.context, f.snippet) for f in _lint("jax", src, sub)]
    assert got == want
    expected = {"unlocked-bad": {"lock-discipline"}, "falsy-attr": {"falsy-int-default"},
                "falsy-call": {"falsy-int-default"}, "np-random-bad": {"np-random-global"},
                "pickle-import": {"pickle-ckpt"}, "pickle-allow": {"pickle-ckpt"},
                "validate-bad": {"validate-routing"}}.get(case, set())
    assert {g[0] for g in got} == expected


def test_port_rules_do_not_apply_under_the_jax_prefix():
    """Each package lints its own library: the port's rules see nothing
    under src/repro/, JAX's nothing under src/repro_torch/."""
    sub, src = LINT_CASES["pickle-import"]
    assert lint_ast.lint_source(src, "src/repro/ckpt/x.py") == []
    assert jax_lint.lint_source(src, "src/repro_torch/ckpt/x.py") == []


def test_port_library_lints_clean():
    root = Path(check._repo_root())
    found = lint_ast.lint_paths(str(root))
    assert found == [], [f.render() for f in found]
    # JAX's rules over the same files, paths mapped to its prefixes
    for path in sorted((root / "src" / "repro_torch").rglob("*.py")):
        rel = path.relative_to(root).as_posix().replace("src/repro_torch/", "src/repro/")
        assert jax_lint.lint_source(path.read_text(), rel) == [], rel


# --------------------------------------------- contract checker, both ways

def test_o_n_intermediate_caught_by_both():
    port = _port(lambda dev: contracts.TraceSpec(
        fn=lambda x: (x @ x.T).sum(dim=0), args=(torch.zeros((N, 8)),),
        dims={"n": N}), no_dims={"n"})
    jx = _jax(lambda: jax_contracts.TraceSpec(
        fn=lambda x: (x @ x.T).sum(axis=0), args=(jnp.zeros((N, 8)),),
        dims={"n": N}), no_dims={"n"})
    assert any(f.rule == "jaxpr-dim" for f in port)
    assert _keys(port) == _keys(jx)
    assert [f.fingerprint for f in port] == [f.fingerprint for f in jx]


def test_candidate_local_equivalent_passes_both():
    # candidate-local: only a gathered window ever materializes
    assert _port(lambda dev: contracts.TraceSpec(
        fn=lambda x: x[:16].sum(dim=1), args=(torch.zeros((N, 8)),),
        dims={"n": N}), no_dims={"n"}) == []
    assert _jax(lambda: jax_contracts.TraceSpec(
        fn=lambda x: x[:16].sum(axis=1), args=(jnp.zeros((N, 8)),),
        dims={"n": N}), no_dims={"n"}) == []


def test_leading_n_view_allowed_but_trailing_n_flagged_by_both():
    def view(x):
        return (x * 2.0).sum()              # (n, d) elementwise view: legal

    def gram(x):
        return (x.T @ x @ x.T).sum(0)       # (d, n): n trails — illegal

    found = {}
    for name, fn in (("view", view), ("gram", gram)):
        Xt, Xj = torch.zeros((N, 4)), jnp.zeros((N, 4))
        found[name] = (
            _port(lambda dev: contracts.TraceSpec(fn=fn, args=(Xt,), dims={"n": N}),
                  no_dims={"n"}),
            _jax(lambda: jax_contracts.TraceSpec(fn=fn, args=(Xj,), dims={"n": N}),
                 no_dims={"n"}))
    assert found["view"] == ([], [])
    port, jx = found["gram"]
    assert any(f.rule == "jaxpr-dim" for f in port)
    assert _keys(port) == _keys(jx)


def test_products_and_1d_rules_match_jax():
    """no_products ("2*n*d" parser) and no_dims_1d through both checkers."""
    def outer(x):
        return (x[:, :, None] * x[:, None, :]).sum()      # (n, d, d) ≥ 2·n·d

    def col(x):
        return x.sum(1) * 2.0                             # (n,) vector

    rules = dict(no_products={"2*n*d"}, no_dims_1d={"n"})
    port = _port(lambda dev: contracts.TraceSpec(
        fn=lambda x: (outer(x), col(x)), args=(torch.ones((N, 4)),),
        dims={"n": N, "d": 4}), **rules)
    jx = _jax(lambda: jax_contracts.TraceSpec(
        fn=lambda x: (outer(x), col(x)), args=(jnp.ones((N, 4)),),
        dims={"n": N, "d": 4}), **rules)
    assert {f.snippet.split(":")[0] for f in port} == {"2*n*d>=2056", "n(1d)=257"}
    assert _keys(port) == _keys(jx)


def test_f64_leak_caught_by_both_and_f32_passes():
    bad = _port(lambda dev: contracts.TraceSpec(
        fn=lambda x: x.to(torch.float64).sum(), args=(torch.zeros((8, 4)),)))
    with jax.enable_x64(True):
        X = jnp.zeros((8, 4), jnp.float32)
        jbad = _jax(lambda: jax_contracts.TraceSpec(
            fn=lambda x: x.astype(jnp.float64).sum(), args=(X,), dims={}))
    assert bad and all(f.rule == "jaxpr-dtype" for f in bad)
    # the same outputs leak: shapes and dtypes agree, op names differ
    assert [f.snippet.split(":")[1] for f in bad] == [f.snippet.split(":")[1] for f in jbad]
    assert [f.rule for f in bad] == [f.rule for f in jbad]
    assert _port(lambda dev: contracts.TraceSpec(
        fn=lambda x: (x * 2.0).sum(), args=(torch.zeros((8, 4)),))) == []


# ------------------------------------------------------------ host syncs

SYNC_CASES = {
    "item": (lambda x: x * 2.0 if (x.sum() > 0).item() else x,
             "aten._local_scalar_dense.default"),
    "bool": (lambda x: x * 2.0 if bool(x.sum() > 0) else x,
             "aten._local_scalar_dense.default"),
    "nonzero": (lambda x: torch.nonzero(x > 0), "aten.nonzero.default"),
    "mask-index": (lambda x: x[x > 0], "aten.index.Tensor:bool-index"),
    "masked-select": (lambda x: torch.masked_select(x, x > 0),
                      "aten.masked_select.default"),
    "unique": (lambda x: torch.unique(x), "aten._unique2.default"),
    "repeat-interleave": (lambda x: torch.repeat_interleave(x, (x > 0).long()),
                          "aten.repeat_interleave.Tensor:no-output_size"),
    "equal": (lambda x: x * 2.0 if torch.equal(x, x) else x, "aten.equal.default"),
}


@pytest.mark.parametrize("case", sorted(SYNC_CASES))
def test_host_sync_caught(case):
    fn, snippet = SYNC_CASES[case]
    X = torch.tensor([1.0, -2.0, 3.0, 0.0])
    found = _port(lambda dev: contracts.TraceSpec(fn=fn, args=(X,)))
    assert [(f.rule, f.snippet) for f in found] == [("host-sync", snippet)]


def test_sync_free_equivalents_pass():
    """The device-side forms of the cases above: a select, a masked fill,
    an int index and repeat_interleave with its output size."""
    X = torch.tensor([1.0, -2.0, 3.0, 0.0])
    rep = torch.tensor([1, 2, 1, 0])

    def fn(x):
        a = torch.where(x.sum() > 0, x * 2.0, x)
        b = x.masked_fill(x < 0, 0.0)
        c = x[torch.tensor([0, 2])]
        d = torch.repeat_interleave(x, rep, output_size=4)
        return a, b, c, d

    assert _port(lambda dev: contracts.TraceSpec(fn=fn, args=(X,))) == []


def test_recorder_keeps_no_tensor():
    rec = contracts.record_ops(contracts.TraceSpec(
        fn=lambda x: (x @ x.T).masked_fill_(x.sum() < 0, 0.0), args=(torch.ones(6, 3),)))
    assert rec.n_ops == len(rec.outputs) == 5
    assert not any(isinstance(v, torch.Tensor)
                   for o in rec.outputs for v in vars(o).values())
    # the in-place fill reports its input's shape, once; the transpose
    # is a view
    assert [o.shape for o in rec.outputs if "masked_fill_" in o.op] == [(6, 6)]
    assert [o.op for o in rec.outputs if o.view] == ["aten.permute.default"]
    assert max(o.nbytes for o in rec.outputs) == 6 * 6 * 4


# ------------------------------------------------------ registered contracts

CONTRACTS = sorted(contracts.REGISTRY)
# the rules the port states in place of JAX's, each with its builder's
# comment: Lloyd's sweep and the fused assignment keep (n,) vectors
DEPARTURES = {"lloyd_sweep": "no_dims_1d", "assign_fused": "no_dims_1d",
              "sharded_assign": "no_dims_1d"}


def test_registry_names_and_rules_match_jax():
    assert CONTRACTS == sorted(jax_contracts.REGISTRY)
    assert contracts.N_TRACE > 16_384 and all(
        contracts.N_TRACE % p for p in range(2, int(contracts.N_TRACE ** 0.5) + 1))
    for name in CONTRACTS:
        a, b = contracts.REGISTRY[name], jax_contracts.REGISTRY[name]
        differ = {r for r in ("no_dims", "no_dims_1d", "no_products", "forbid_dtypes")
                  if getattr(a, r) != getattr(b, r)}
        assert differ == ({DEPARTURES[name]} if name in DEPARTURES else set()), name
        if name in DEPARTURES:
            # the port drops the 1-D rule and keeps every other
            assert a.no_dims_1d == frozenset() and b.no_dims_1d == {"n"}
            assert a.no_products == b.no_products == {"n*c"}


@pytest.mark.parametrize("name", CONTRACTS)
def test_contract_clean_on_cpu(name):
    found = contracts.check_contract(contracts.REGISTRY[name], "cpu")
    assert found == [], [f.render() for f in found]


def test_search_jit_has_no_database_sized_intermediates():
    """The port's counterpart of tests/test_search_pipeline.py's pin: no
    (n,)- or (nq, n)-shaped output anywhere in `search_jit`."""
    from repro_torch.core.search import search_jit
    _, Q = contracts._tiny_dataset()
    idx, packed = contracts._tiny_index("cpu")
    n = idx.n_points
    rec = contracts.record_ops(contracts.TraceSpec(
        fn=lambda p, q: search_jit(p, q, top_t=contracts.TOP_T,
                                   final_k=contracts.FINAL_K, rerank_budget=256),
        args=(packed, torch.as_tensor(Q))))
    shapes = {o.shape for o in rec.outputs}
    bad = [s for s in shapes if s == (n,) or (len(s) == 2 and s[1] == n)]
    assert not bad, f"database-sized intermediates in search_jit: {bad}"
    assert rec.syncs == [] and all(o.dtype != "float64" for o in rec.outputs)


def test_filter_conversion_is_outside_the_contract():
    """A filter passed as a bool or a numpy array is converted to the
    (n,) uint8 bitmap inside the search: the contract passes it converted,
    as JAX's spec passes a jnp array, so no (n,) output is exempted."""
    from repro_torch.core.search import search_jit_batched
    _, Q = contracts._tiny_dataset()
    _, packed = contracts._tiny_index("cpu")
    mask = np.random.default_rng(3).random(contracts.N_TRACE) < 0.3
    spec = contracts.TraceSpec(
        fn=lambda p, q, f: search_jit_batched(p, q, top_t=contracts.TOP_T,
                                              final_k=contracts.FINAL_K, filter=f),
        args=(packed, torch.as_tensor(Q), torch.as_tensor(mask)),
        dims={"n": contracts.N_TRACE})
    found = contracts.evaluate(contracts.REGISTRY["search_jit_batched_filtered"], spec,
                               contracts.record_ops(spec))
    assert [f.snippet for f in found] == [f"n={contracts.N_TRACE}:[({contracts.N_TRACE},)]"]


@pytest.mark.parametrize("name", ["assign_fused", "sharded_assign"])
def test_fused_assignment_keeps_an_n_vector(name):
    """The stated departure: the fused assignment hands an (n,) primary
    to the spill step, so JAX's no_dims_1d would flag the port's trace;
    the port's rule (no_products n*c) holds."""
    c = contracts.REGISTRY[name]
    spec = c.build(torch.device("cpu"))
    rec = contracts.record_ops(spec)
    n = spec.dims["n"]
    assert (n,) in {o.shape for o in rec.outputs if o.dtype == "int32"}
    jax_rule = contracts.JaxprContract(name, c.build, no_dims_1d=frozenset({"n"}),
                                       no_products=c.no_products)
    assert [f.snippet.split(":")[0] for f in contracts.evaluate(jax_rule, spec, rec)] \
        == [f"n(1d)={n}"]
    assert contracts.evaluate(c, spec, rec) == []


def test_lloyd_plain_sweep_meets_the_jax_rule():
    """Lloyd's departure is the card's design (its (n,) idx and mind
    between the two launches, tests/test_torch_cuda.py): the plain sweep
    on the CPU still meets JAX's no_dims_1d."""
    c = contracts.REGISTRY["lloyd_sweep"]
    spec = c.build(torch.device("cpu"))
    jax_rule = contracts.JaxprContract("lloyd_sweep", c.build,
                                       no_dims_1d=frozenset({"n"}),
                                       no_products=c.no_products)
    assert contracts.evaluate(jax_rule, spec, contracts.record_ops(spec)) == []


# -------------------------------------------------------------------- CLI

def test_cli_clean_on_repo_cpu(tmp_path):
    report = tmp_path / "r.json"
    assert check.main(["--device", "cpu", "-q", "--report", str(report)]) == 0
    r = json.loads(report.read_text())
    assert r["new"] == [] and r["passes"] == ["lint", "contracts"]


@pytest.mark.parametrize("cls", check.INJECT_CLASSES)
def test_cli_injected_violations_exit_nonzero(cls):
    assert check.main(["--only", "lint", "--inject", cls, "--device", "cpu", "-q"]) != 0


def test_cli_baseline_grandfathers_an_injection(tmp_path):
    bl = str(tmp_path / "bl.json")
    args = ["--only", "lint", "--inject", "unlocked-call", "--device", "cpu", "-q",
            "--baseline", bl]
    assert check.main(args + ["--update-baseline"]) == 0
    assert check.main(args) == 0
    assert check.main(["--only", "lint", "--inject", "falsy-default", "--device", "cpu",
                       "-q", "--baseline", bl]) == 1
