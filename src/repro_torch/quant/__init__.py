"""Quantization (PyTorch port of `repro/quant`): product quantization,
scalar int8 rerank rows, anisotropic (score-aware) VQ."""
from repro_torch.quant.int8 import (Int8Data, int8_dequantize,  # noqa: F401
                                    int8_quantize, int8_score)
from repro_torch.quant.pq import (PQCodebook, pq_decode, pq_encode,  # noqa: F401
                                  pq_lut, pq_score, pq_score_batch, train_pq,
                                  train_pq_sequential)
