"""Model configuration for the assigned architecture pool (the port's own
copy of `repro/models/config.py`; nothing here imports the JAX package).

A model is a stack of GROUPS; each group is `block_pattern` applied once
(`n_layers == n_groups * len(block_pattern)`). Uniform transformers have
pattern ("attn",); hybrids interleave block kinds. Parameters of each
pattern-position are stacked over the group axis (JAX's layout); the port
walks the stack group by group.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # None → d_model // n_heads
    # block structure (one group): entries "attn" | "mamba" | "mlstm" | "slstm"
    block_pattern: Tuple[str, ...] = ("attn",)
    # which pattern positions carry an MoE MLP instead of dense (by index)
    moe_positions: Tuple[int, ...] = ()
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # MLP flavor: "swiglu" | "geglu" | "squared_relu" | "gelu" | "none"
    mlp: str = "swiglu"
    # SSM / recurrent dims
    ssm_state_dim: int = 16
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    # attention details
    rope_theta: float = 10_000.0
    causal: bool = True              # False → encoder-only (bidirectional)
    # modality frontend (stub per spec): "" | "audio" | "vision"
    frontend: str = ""
    n_prefix_embeds: int = 0         # VLM: # of patch embeddings prepended
    logit_softcap: float = 0.0
    norm_eps: float = 1e-6
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # serving / distribution knobs
    remat: str = "block"             # "none" | "block": checkpoint each group in training
    # sub-quadratic? (controls long_500k applicability)
    subquadratic: bool = False

    @property
    def hd(self) -> int:
        # `is None` sentinel, NOT `or`: an explicit head_dim=0 is a config
        # error that must surface, never silently coalesce to the default
        if self.head_dim is None:
            return self.d_model // self.n_heads
        return self.head_dim

    @property
    def cache_dtype(self) -> str:
        """KV-cache / recurrent-state dtype follows the compute dtype."""
        return "bfloat16" if self.compute_dtype == "bfloat16" else "float32"

    @property
    def n_groups(self) -> int:
        assert self.n_layers % len(self.block_pattern) == 0, \
            (self.name, self.n_layers, self.block_pattern)
        return self.n_layers // len(self.block_pattern)

    @property
    def has_decode(self) -> bool:
        return self.causal

    @property
    def d_inner(self) -> int:        # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def vocab_padded(self) -> int:
        return ((self.vocab_size + 255) // 256) * 256

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def smoke_config(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        n_pat = len(self.block_pattern)
        return self.replace(
            name=self.name + "-smoke",
            n_layers=n_pat * 2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            moe_d_ff=32 if self.moe_d_ff else 0,
            n_experts=min(self.n_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            vocab_size=256,
            n_prefix_embeds=min(self.n_prefix_embeds, 4),
            ssm_state_dim=4,
        )


# --------------------------------------------------------------------------
# Shape cells (assigned input shapes; LM shapes are seq_len × global_batch)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, shape: ShapeCell) -> tuple[bool, str]:
    """Spec'd skip rules (documented in DESIGN.md §Shape skips)."""
    if shape.kind == "decode" and not cfg.has_decode:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k requires sub-quadratic attention (SSM/hybrid only)"
    return True, ""
