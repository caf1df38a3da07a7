"""moonshot-v1-16b-a3b [moe] — 48L d_model=2048 16H (kv=16, MHA) d_ff=1408
(expert) vocab=163840, MoE 64 experts top-6 (kimi/moonlight).
[hf:moonshotai/Moonlight-16B-A3B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=0, vocab_size=163840, mlp="swiglu",
    moe_positions=(0,), n_experts=64, experts_per_token=6, moe_d_ff=1408,
)
