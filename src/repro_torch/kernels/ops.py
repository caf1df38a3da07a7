"""Public kernel entry points, mirroring `repro/kernels/ops.py`.

Each takes the CUDA kernel for CUDA tensors and its plain PyTorch version
for CPU tensors (see the modules named below). `pq_score_probes`, which
reads each query's probed partitions by id, stands where the JAX package
has the gathered-window `pq_score_window`.
"""
from __future__ import annotations

from repro_torch.kernels.pq_score import pq_score, pq_score_probes  # noqa: F401
from repro_torch.kernels.soar_assign import soar_assign  # noqa: F401
from repro_torch.kernels.vq_assign import vq_assign  # noqa: F401
