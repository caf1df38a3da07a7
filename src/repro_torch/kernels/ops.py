"""Public kernel entry points, mirroring `repro/kernels/ops.py`.

Each takes the CUDA kernel for CUDA tensors and its plain PyTorch version
for CPU tensors (see the modules named below).
"""
from __future__ import annotations

from repro_torch.kernels.pq_score import pq_score, pq_score_window  # noqa: F401
from repro_torch.kernels.soar_assign import soar_assign  # noqa: F401
from repro_torch.kernels.vq_assign import vq_assign  # noqa: F401
