"""CLI: `python -m repro_torch.analysis.check` — run the port's static
contract analyzer (op-trace contracts + AST lints) against the repo and
exit nonzero on any finding not grandfathered by the committed ratchet
baseline (DESIGN.md §3.14). PyTorch port of `repro/analysis/check.py`.

    python -m repro_torch.analysis.check                  # full run, CUDA
    python -m repro_torch.analysis.check --device cpu     # full run, CPU
    python -m repro_torch.analysis.check --skip contracts # passes are skippable
    python -m repro_torch.analysis.check --report findings.json
    python -m repro_torch.analysis.check --update-baseline   # re-ratchet
    python -m repro_torch.analysis.check --inject f64-leak   # self-test:
                                                             # must exit nonzero

The contracts and the injections that trace run on `--device` (CUDA unless
the caller passes "cpu"; no card raises, never a silent fall-back to the
CPU). Exit codes as the JAX package's: 0 clean, 1 a new finding, 2 an
injected violation that was not detected.

--inject runs a synthetic violation of the named class through the SAME
pass machinery (not a fabricated finding), so CI can verify each detector
actually detects: o-n-intermediate | f64-leak | host-sync | unlocked-call
| falsy-default. `host-sync` is the counterpart of the JAX package's
callback case; torch has no jit cache, so there is no `cache-growth`.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import textwrap
from typing import List, Optional

from repro_torch.analysis.findings import (Finding, load_baseline,
                                           partition_findings, save_baseline)

PASSES = ("lint", "contracts")
INJECT_CLASSES = ("o-n-intermediate", "f64-leak", "host-sync",
                  "unlocked-call", "falsy-default")


def _repo_root(explicit: Optional[str] = None) -> str:
    if explicit:
        return os.path.abspath(explicit)
    here = os.path.abspath(os.path.join(os.path.dirname(__file__),
                                        "..", "..", ".."))
    if os.path.isdir(os.path.join(here, "src", "repro_torch")):
        return here
    return os.getcwd()


# ------------------------------------------------------------- injections
# Each injector drives a deliberately-violating synthetic target through
# the real pass, proving the detector fires (the CLI exits nonzero on
# every class).

def _inject_contract(name: str, build, device, **rules) -> List[Finding]:
    from repro_torch.analysis.contracts import check_contract, jaxpr_contract
    reg: dict = {}
    jaxpr_contract(name, registry=reg, **rules)(build)
    return check_contract(reg[name], device)


def _inject_o_n_intermediate(device) -> List[Finding]:
    import torch

    def spec(dev):
        from repro_torch.analysis.contracts import TraceSpec
        X = torch.zeros((521, 8), device=dev)
        # (n, n) similarity matrix: exactly the database-sized
        # intermediate the candidate-local pipeline forbids
        return TraceSpec(fn=lambda x: (x @ x.T).sum(dim=0), args=(X,),
                         dims={"n": 521})

    return _inject_contract("injected_o_n", spec, device, no_dims={"n"})


def _inject_f64_leak(device) -> List[Finding]:
    import torch

    def spec(dev):
        from repro_torch.analysis.contracts import TraceSpec
        X = torch.zeros((16, 8), device=dev)
        return TraceSpec(fn=lambda x: x.to(torch.float64).sum(), args=(X,))

    return _inject_contract("injected_f64", spec, device)


def _inject_host_sync(device) -> List[Finding]:
    import torch

    def spec(dev):
        from repro_torch.analysis.contracts import TraceSpec

        def noisy(x):
            # a Python branch on a device value: the host waits for it
            return x * 2.0 if (x.sum() > 0).item() else x
        return TraceSpec(fn=noisy, args=(torch.ones(4, device=dev),))

    return _inject_contract("injected_sync", spec, device)


_UNLOCKED_SRC = textwrap.dedent("""\
    class Frontend:
        def _expire_locked(self):
            pass

        def poll(self):
            self._expire_locked()       # no lock held: must be flagged
""")

_FALSY_SRC = textwrap.dedent("""\
    def probe(self, top_t=None):
        top_t = top_t or self.top_t     # explicit 0 silently coalesced
        return top_t
""")


def _inject_unlocked_call(device) -> List[Finding]:
    from repro_torch.analysis.lint_ast import lint_source
    return lint_source(_UNLOCKED_SRC, "src/repro_torch/serve/_injected.py")


def _inject_falsy_default(device) -> List[Finding]:
    from repro_torch.analysis.lint_ast import lint_source
    return lint_source(_FALSY_SRC, "src/repro_torch/core/_injected.py")


_INJECTORS = {
    "o-n-intermediate": _inject_o_n_intermediate,
    "f64-leak": _inject_f64_leak,
    "host-sync": _inject_host_sync,
    "unlocked-call": _inject_unlocked_call,
    "falsy-default": _inject_falsy_default,
}


# -------------------------------------------------------------------- main

def run_passes(root: str, passes, device=None,
               verbose: bool = False) -> List[Finding]:
    findings: List[Finding] = []
    if "lint" in passes:
        from repro_torch.analysis.lint_ast import lint_paths
        found = lint_paths(root)
        if verbose:
            print(f"[lint] {len(found)} finding(s)")
        findings.extend(found)
    if "contracts" in passes:
        from repro_torch.analysis.contracts import (REGISTRY,
                                                    check_all_contracts)
        found = check_all_contracts(device=device)
        if verbose:
            print(f"[contracts] {len(REGISTRY)} contract(s), "
                  f"{len(found)} finding(s)")
        findings.extend(found)
    return findings


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.check",
        description="Static contract analyzer of the PyTorch port "
                    "(DESIGN.md §3.14)")
    ap.add_argument("--root", default=None, help="repo root (default: "
                    "inferred from this module's location)")
    ap.add_argument("--skip", action="append", default=[],
                    choices=PASSES, help="skip a pass (repeatable)")
    ap.add_argument("--only", action="append", default=[],
                    choices=PASSES, help="run only these passes")
    ap.add_argument("--report", default=None,
                    help="write the findings report (JSON) here")
    ap.add_argument("--baseline", default=None,
                    help="ratchet baseline path (default: committed "
                    "src/repro_torch/analysis/baseline.json)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="grandfather all current findings and exit 0")
    ap.add_argument("--inject", choices=INJECT_CLASSES, default=None,
                    help="self-test: add a synthetic violation of this "
                    "class (the run must then exit nonzero)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device the contracts trace on (default: cuda)")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    passes = [p for p in (args.only or PASSES) if p not in args.skip]
    root = _repo_root(args.root)
    findings = run_passes(root, passes, args.device, verbose=not args.quiet)
    if args.inject:
        injected = _INJECTORS[args.inject](args.device)
        if not injected:
            print(f"INJECTION FAILED: synthetic `{args.inject}` violation "
                  f"was not detected", file=sys.stderr)
            return 2
        findings.extend(injected)

    baseline = load_baseline(args.baseline)
    new, grandfathered = partition_findings(findings, baseline)

    if args.report:
        with open(args.report, "w") as fh:
            json.dump({
                "passes": passes,
                "device": args.device,
                "new": [f.to_dict() for f in new],
                "grandfathered": [f.to_dict() for f in grandfathered],
            }, fh, indent=2)
            fh.write("\n")

    for f in grandfathered:
        print(f.render(grandfathered=True))
    for f in new:
        print(f.render())
    if args.update_baseline:
        save_baseline(findings, args.baseline)
        print(f"baseline updated: {len(findings)} finding(s) "
              f"grandfathered")
        return 0
    if not args.quiet or new:
        print(f"repro_torch.analysis.check: {len(new)} new finding(s), "
              f"{len(grandfathered)} grandfathered, passes: "
              f"{', '.join(passes)}, device: {args.device}")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
