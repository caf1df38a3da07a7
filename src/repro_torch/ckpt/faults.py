"""Import shim (as `repro/ckpt/faults.py` is for the JAX package): the
fault-injection seam lives in ``repro_torch.faults``, and importing it
through this path shares the same installed plans."""
from repro_torch.faults import (FaultPlan, InjectedCrash, InjectedFault,
                                InjectedTransientFault, active, crash_point,
                                flip_byte, inject, install, serve_point,
                                truncate_tail, uninstall, write)

__all__ = ["FaultPlan", "InjectedCrash", "InjectedFault",
           "InjectedTransientFault", "active", "crash_point", "flip_byte",
           "inject", "install", "serve_point", "truncate_tail",
           "uninstall", "write"]
