"""Static contract analyzer of the PyTorch port (DESIGN.md §3.14): op-trace
contracts over the entry points and repo-specific AST lints, gated via
`python -m repro_torch.analysis.check`. Counterpart of `repro.analysis`
less its jaxpr walker (torch has no jaxpr: `contracts.OpRecorder` stands
for it) and its recompile sentinel (torch has no jit cache).

Import surface:
  jaxpr_contract / check_all_contracts        declarative contract registry
  lint_source / lint_paths                    AST lint pass
  Finding / load_baseline                     findings + ratchet baseline
"""
from repro_torch.analysis.findings import (Finding, load_baseline,  # noqa: F401
                                           partition_findings, save_baseline)


def __getattr__(name):
    # contracts import torch's dispatch machinery and the search layers —
    # load lazily so `from repro_torch.analysis import Finding` stays cheap
    if name in ("jaxpr_contract", "check_all_contracts", "check_contract",
                "TraceSpec", "REGISTRY", "HOST_SYNC_OPS", "OpRecorder",
                "record_ops"):
        from repro_torch.analysis import contracts
        return getattr(contracts, name)
    if name in ("lint_source", "lint_paths"):
        from repro_torch.analysis import lint_ast
        return getattr(lint_ast, name)
    raise AttributeError(name)
