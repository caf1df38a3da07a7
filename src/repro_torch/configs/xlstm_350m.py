"""xlstm-350m [ssm] — 24L d_model=1024 4H d_ff=0 vocab=50304.
sLSTM + mLSTM blocks in the xLSTM[7:1] ratio (7 mLSTM : 1 sLSTM per group of
8; 24 layers = 3 groups). Attention-free → sub-quadratic → runs long_500k.
[arXiv:2405.04517; unverified]

SOAR applicability (DESIGN.md §Arch-applicability): kNN-attention memory is
inapplicable (no KV); the arch is built without the paper's technique.

Sharding: 4 heads don't divide the 16-way model axis → the 256-wide value
dim ("head") is sharded instead; sLSTM is tiny and stays replicated.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, head_dim=256,
    d_ff=0, vocab_size=50304, mlp="none",
    block_pattern=("mlstm",) * 7 + ("slstm",),
    subquadratic=True,
)

RULE_OVERRIDES = {"heads": None, "head": "model"}
