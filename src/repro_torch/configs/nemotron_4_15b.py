"""nemotron-4-15b [dense] — 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000. GQA, squared-ReLU MLP. [arXiv:2402.16819; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=256000, mlp="squared_relu",
)
