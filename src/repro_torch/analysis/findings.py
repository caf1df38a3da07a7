"""Finding model + ratchet baseline for the port's static contract
analyzer (PyTorch port of `repro/analysis/findings.py`).

Every analysis pass (op-trace contracts, AST lints) reports `Finding`s.
A finding's identity is its *fingerprint* — a hash of (rule, path,
context, snippet) that deliberately excludes line numbers, so
unrelated edits that shift a grandfathered violation down the file don't
resurrect it. The committed baseline (`baseline.json`, next to this
module) is the ratchet: fingerprints listed there are reported but don't
fail the build; anything new does (DESIGN.md §3.14).

The fingerprint key and hash and the baseline file are the JAX package's,
so one finding has one fingerprint in both packages and each package
reads the other's baseline.
"""
from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field, asdict
from typing import Iterable, List, Optional

BASELINE_PATH = os.path.join(os.path.dirname(__file__), "baseline.json")


@dataclass(frozen=True)
class Finding:
    """One violation from one pass.

    rule:    stable rule id ("jaxpr-dim", "jaxpr-dtype", "host-sync",
             "lock-discipline", "falsy-int-default", "np-random-global",
             "pickle-ckpt", "validate-routing", ...).
    path:    repo-relative file path, or "contract:<name>" for
             non-file findings.
    line:    1-based line for file findings, 0 otherwise (display only —
             not part of the fingerprint).
    context: enclosing scope: function qualname for lints, the traced
             entry point for contracts.
    snippet: the offending source fragment / shape / dtype / op — the part
             of the identity that survives reformatting around it.
    """
    rule: str
    path: str
    message: str
    line: int = 0
    context: str = ""
    snippet: str = ""

    @property
    def fingerprint(self) -> str:
        key = "|".join((self.rule, self.path, self.context, self.snippet))
        return hashlib.sha256(key.encode()).hexdigest()[:16]

    def render(self, grandfathered: bool = False) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        tag = " [grandfathered]" if grandfathered else ""
        ctx = f" (in {self.context})" if self.context else ""
        return f"{loc}: {self.rule}: {self.message}{ctx}{tag}"

    def to_dict(self) -> dict:
        d = asdict(self)
        d["fingerprint"] = self.fingerprint
        return d


@dataclass
class Baseline:
    """The committed ratchet file: grandfathered fingerprints."""
    fingerprints: set = field(default_factory=set)
    entries: list = field(default_factory=list)

    def __contains__(self, f) -> bool:
        fp = f.fingerprint if isinstance(f, Finding) else f
        return fp in self.fingerprints


def load_baseline(path: Optional[str] = None) -> Baseline:
    path = path or BASELINE_PATH
    if not os.path.exists(path):
        return Baseline()
    with open(path) as fh:
        data = json.load(fh)
    entries = data.get("grandfathered", [])
    return Baseline({e["fingerprint"] for e in entries}, entries)


def save_baseline(findings: Iterable[Finding],
                  path: Optional[str] = None) -> None:
    """Rewrite the ratchet to grandfather exactly `findings`. Used by
    `python -m repro_torch.analysis.check --update-baseline` after a
    deliberate decision to allowlist (rather than fix) surviving violations."""
    path = path or BASELINE_PATH
    entries = sorted(
        ({"fingerprint": f.fingerprint, "rule": f.rule, "path": f.path,
          "context": f.context, "message": f.message} for f in findings),
        key=lambda e: (e["rule"], e["path"], e["fingerprint"]))
    with open(path, "w") as fh:
        json.dump({"version": 1, "grandfathered": entries}, fh, indent=2)
        fh.write("\n")


def partition_findings(findings: Iterable[Finding],
                       baseline: Baseline) -> tuple:
    """→ (new, grandfathered): only `new` fails the build."""
    new: List[Finding] = []
    old: List[Finding] = []
    for f in findings:
        (old if f in baseline else new).append(f)
    return new, old
