"""hubert-xlarge [audio] — 48L d_model=1280 16H (kv=16, MHA) d_ff=5120
vocab=504 (masked-unit prediction targets). Encoder-only, bidirectional;
the CNN waveform frontend is a STUB per spec: input_specs() provides
precomputed frame embeddings. No decode step → decode shapes skipped.
[arXiv:2106.07447; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab_size=504, mlp="gelu",
    causal=False, frontend="audio",
)
