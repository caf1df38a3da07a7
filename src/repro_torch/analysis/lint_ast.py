"""Repo-specific AST lints (stdlib `ast`, no new deps) — DESIGN.md §3.14.
PyTorch port of `repro/analysis/lint_ast.py`: the same five rules over the
port's library code; only the path prefixes differ.

Rules (library code under src/repro_torch only; tests/benchmarks are
exempt):

  lock-discipline    serve/: a `self.*_locked(...)` call must happen
                     lexically under `with self._lock:` / `with
                     self._cond:` (or inside another `*_locked` method —
                     the caller-holds-the-lock convention of
                     serve/frontend.py).
  falsy-int-default  `x or <numeric default>` coalescing on an int param
                     treats an explicit 0 as "unset" — the
                     `top_t or self.top_t` bug class. Use
                     `if x is None` sentinels.
  np-random-global   `np.random.<fn>()` global-state RNG in library code
                     (only `default_rng`/`Generator`/`SeedSequence` are
                     allowed — reproducibility requires threaded keys).
  pickle-ckpt        ckpt/: pickle-family imports or
                     `allow_pickle=True` — the durability layer's framing
                     is self-describing arrays + JSON, never pickle
                     (§3.11: untrusted snapshots must not execute code).
  validate-routing   serve/: engine-edge entry points (search /
                     search_request / retrieve / retrieve_request /
                     submit) must reach `SearchParams.validate()` —
                     directly or through a self-call chain.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set

from repro_torch.analysis.findings import Finding

ENTRY_POINT_NAMES = {"search", "search_request", "retrieve",
                     "retrieve_request", "submit"}
LOCK_ATTRS = {"_lock", "_cond"}
ALLOWED_NP_RANDOM = {"default_rng", "Generator", "SeedSequence", "PCG64",
                     "Philox", "bit_generator"}
PICKLE_MODULES = {"pickle", "cPickle", "dill", "shelve"}
NUMERIC_CALL_NAMES = {"max", "min", "int", "len", "round", "abs"}


def _seg(src: str, node: ast.AST) -> str:
    return (ast.get_source_segment(src, node) or "").strip()


def _is_self_attr(node: ast.AST, attrs: Set[str]) -> bool:
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self" and node.attr in attrs)


# identifier fragments that mark a name as integer-like — `top_t or
# self.top_t` (the bug class, verbatim) must trip the rule even though the
# fallback is a bare attribute rather than a literal
INT_NAME_HINTS = ("top_t", "t_route", "head_dim", "n_partitions", "chunk",
                  "budget", "batch", "bq", "pmax", "n_local", "n_spills",
                  "capacity", "n_heads", "seq", "iters", "steps", "size",
                  "count", "width", "depth")


def _int_like_name(name: str) -> bool:
    n = name.lower()
    return n in ("k", "n", "c", "d", "m") or any(h in n
                                                 for h in INT_NAME_HINTS)


def _is_numeric_default(node: ast.AST) -> bool:
    """Does this `or`-fallback look like an integer default? int literals,
    arithmetic, max()/min()/int()/len() calls, unary minus thereof, or an
    int-like-named name/attribute (the `x or self.x` shape)."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, int) and not isinstance(node.value,
                                                              bool)
    if isinstance(node, ast.UnaryOp):
        return _is_numeric_default(node.operand)
    if isinstance(node, ast.BinOp):
        return True
    if isinstance(node, ast.Call):
        f = node.func
        name = f.id if isinstance(f, ast.Name) else (
            f.attr if isinstance(f, ast.Attribute) else "")
        return name in NUMERIC_CALL_NAMES
    if isinstance(node, ast.Attribute):
        return _int_like_name(node.attr)
    if isinstance(node, ast.Name):
        return _int_like_name(node.id)
    return False


class _FunctionStack(ast.NodeVisitor):
    """Base visitor tracking the enclosing function qualname."""

    def __init__(self) -> None:
        self.stack: List[str] = []

    @property
    def context(self) -> str:
        return ".".join(self.stack)

    def _walk_fn(self, node) -> None:
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    def visit_FunctionDef(self, node):          # noqa: N802
        self._walk_fn(node)

    def visit_AsyncFunctionDef(self, node):     # noqa: N802
        self._walk_fn(node)

    def visit_ClassDef(self, node):             # noqa: N802
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()


class _LockDiscipline(_FunctionStack):
    def __init__(self, src: str, relpath: str) -> None:
        super().__init__()
        self.src, self.relpath = src, relpath
        self.lock_depth = 0
        self.findings: List[Finding] = []

    def visit_With(self, node):                 # noqa: N802
        held = any(_is_self_attr(item.context_expr, LOCK_ATTRS)
                   for item in node.items)
        self.lock_depth += held
        self.generic_visit(node)
        self.lock_depth -= held

    def visit_Call(self, node):                 # noqa: N802
        f = node.func
        if (isinstance(f, ast.Attribute) and f.attr.endswith("_locked")
                and isinstance(f.value, ast.Name) and f.value.id == "self"
                and self.lock_depth == 0
                and not (self.stack and self.stack[-1].endswith("_locked"))):
            self.findings.append(Finding(
                "lock-discipline", self.relpath, line=node.lineno,
                context=self.context, snippet=_seg(self.src, node),
                message=(f"`self.{f.attr}()` called without holding "
                         f"self._lock/self._cond")))
        self.generic_visit(node)


class _FalsyIntDefault(_FunctionStack):
    def __init__(self, src: str, relpath: str) -> None:
        super().__init__()
        self.src, self.relpath = src, relpath
        self.findings: List[Finding] = []

    def visit_BoolOp(self, node):               # noqa: N802
        if (isinstance(node.op, ast.Or) and len(node.values) == 2
                and isinstance(node.values[0], (ast.Name, ast.Attribute))
                and _is_numeric_default(node.values[1])):
            self.findings.append(Finding(
                "falsy-int-default", self.relpath, line=node.lineno,
                context=self.context, snippet=_seg(self.src, node),
                message=("`or`-coalescing on an integer param treats an "
                         "explicit 0 as unset — use an `is None` "
                         "sentinel")))
        self.generic_visit(node)


class _NpRandomGlobal(_FunctionStack):
    def __init__(self, src: str, relpath: str) -> None:
        super().__init__()
        self.src, self.relpath = src, relpath
        self.findings: List[Finding] = []

    def visit_Attribute(self, node):            # noqa: N802
        # np.random.X  /  numpy.random.X
        v = node.value
        if (isinstance(v, ast.Attribute) and v.attr == "random"
                and isinstance(v.value, ast.Name)
                and v.value.id in ("np", "numpy")
                and node.attr not in ALLOWED_NP_RANDOM):
            self.findings.append(Finding(
                "np-random-global", self.relpath, line=node.lineno,
                context=self.context, snippet=_seg(self.src, node),
                message=(f"global-state RNG `np.random.{node.attr}` in "
                         f"library code — use np.random.default_rng / "
                         f"torch.Generator")))
        self.generic_visit(node)


class _PickleInCkpt(_FunctionStack):
    def __init__(self, src: str, relpath: str) -> None:
        super().__init__()
        self.src, self.relpath = src, relpath
        self.findings: List[Finding] = []

    def _flag(self, node, what: str) -> None:
        self.findings.append(Finding(
            "pickle-ckpt", self.relpath, line=node.lineno,
            context=self.context, snippet=_seg(self.src, node),
            message=(f"{what} in the durability layer — snapshots/WAL "
                     f"must stay self-describing arrays + JSON "
                     f"(§3.11), never executable payloads")))

    def visit_Import(self, node):               # noqa: N802
        for a in node.names:
            if a.name.split(".")[0] in PICKLE_MODULES:
                self._flag(node, f"`import {a.name}`")

    def visit_ImportFrom(self, node):           # noqa: N802
        if node.module and node.module.split(".")[0] in PICKLE_MODULES:
            self._flag(node, f"`from {node.module} import ...`")

    def visit_Call(self, node):                 # noqa: N802
        for kw in node.keywords:
            if (kw.arg == "allow_pickle"
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value is True):
                self._flag(node, "`allow_pickle=True`")
        self.generic_visit(node)


def _method_calls_and_validate(fn_node) -> tuple:
    """(self-method names called, does the body call `.validate(...)`)."""
    calls: Set[str] = set()
    validates = False
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            if node.func.attr == "validate":
                validates = True
            if (isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "self"):
                calls.add(node.func.attr)
    return calls, validates


def _check_validate_routing(tree, src: str, relpath: str) -> List[Finding]:
    findings: List[Finding] = []
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        methods = {m.name: m for m in cls.body
                   if isinstance(m, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))}
        entries = [m for name, m in methods.items()
                   if name in ENTRY_POINT_NAMES]
        if not entries:
            continue
        graph: Dict[str, Set[str]] = {}
        validates: Dict[str, bool] = {}
        for name, m in methods.items():
            graph[name], validates[name] = _method_calls_and_validate(m)
        for m in entries:
            seen, todo = set(), [m.name]
            ok = False
            while todo:
                cur = todo.pop()
                if cur in seen or cur not in methods:
                    continue
                seen.add(cur)
                if validates[cur]:
                    ok = True
                    break
                todo.extend(graph[cur])
            if not ok:
                findings.append(Finding(
                    "validate-routing", relpath, line=m.lineno,
                    context=f"{cls.name}.{m.name}",
                    snippet=f"def {m.name}",
                    message=(f"engine-edge entry point `{cls.name}."
                             f"{m.name}` never reaches SearchParams."
                             f"validate() — the single hardened "
                             f"validation path (§3.12)")))
    return findings


def lint_source(src: str, relpath: str) -> List[Finding]:
    """Lint one module's source. `relpath` (repo-relative, '/'-separated)
    selects which rules apply."""
    relpath = relpath.replace(os.sep, "/")
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding("syntax-error", relpath,
                        line=(0 if e.lineno is None else e.lineno),
                        message=str(e))]
    findings: List[Finding] = []
    in_src = relpath.startswith("src/repro_torch/")
    if in_src:
        for visitor_cls in (_FalsyIntDefault, _NpRandomGlobal):
            v = visitor_cls(src, relpath)
            v.visit(tree)
            findings.extend(v.findings)
    if relpath.startswith("src/repro_torch/serve/"):
        v = _LockDiscipline(src, relpath)
        v.visit(tree)
        findings.extend(v.findings)
        findings.extend(_check_validate_routing(tree, src, relpath))
    if relpath.startswith("src/repro_torch/ckpt/"):
        v = _PickleInCkpt(src, relpath)
        v.visit(tree)
        findings.extend(v.findings)
    return findings


def lint_paths(root: str, paths: Optional[List[str]] = None
               ) -> List[Finding]:
    """Lint every library module under `root` (or just `paths`,
    repo-relative)."""
    findings: List[Finding] = []
    if paths is None:
        paths = []
        src_root = os.path.join(root, "src", "repro_torch")
        for dirpath, _, files in os.walk(src_root):
            for f in sorted(files):
                if f.endswith(".py"):
                    paths.append(os.path.relpath(os.path.join(dirpath, f),
                                                 root))
    for rel in sorted(paths):
        with open(os.path.join(root, rel)) as fh:
            findings.extend(lint_source(fh.read(), rel))
    return findings
