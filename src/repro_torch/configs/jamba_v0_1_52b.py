"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2. Mamba:attention 7:1 interleave (one attn
per group of 8, position 3 as in the paper), MoE every other layer.
Mamba state + 1:8 attention → sub-quadratic → runs long_500k with the
attention KV cache seq-sharded. [arXiv:2403.19887; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=65536, mlp="swiglu",
    block_pattern=("mamba", "mamba", "mamba", "attn",
                   "mamba", "mamba", "mamba", "mamba"),
    moe_positions=(1, 3, 5, 7), n_experts=16, experts_per_token=2,
    moe_d_ff=14336,
    ssm_state_dim=16, ssm_conv_width=4, ssm_expand=2,
    subquadratic=True,
)
