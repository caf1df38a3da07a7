"""paligemma-3b [vlm] — 18L d_model=2048 8H (GQA kv=1, i.e. MQA) d_ff=16384
vocab=257216. SigLIP frontend is a STUB per spec: input_specs() provides 256
precomputed patch embeddings; the gemma decoder uses a prefix-LM mask over
them. [arXiv:2407.07726; hf]

Sharding note (DESIGN.md §6): 8 q-heads don't divide the 16-way model axis;
attention weights stay replicated (they're 2% of params) and the model axis
shards the 16384-wide MLP + the 257k vocab, which dominate.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=257216, mlp="geglu",
    frontend="vision", n_prefix_embeds=256,
)

RULE_OVERRIDES = {"heads": None, "head": None, "kv_heads": None}
