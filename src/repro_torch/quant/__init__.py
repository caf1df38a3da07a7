"""Quantization (PyTorch port of `repro/quant`): product quantization."""
from repro_torch.quant.pq import (PQCodebook, pq_encode, pq_lut,  # noqa: F401
                                  train_pq)
