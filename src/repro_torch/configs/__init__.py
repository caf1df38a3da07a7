"""Architecture registry (PyTorch port of `repro/configs`): --arch <id>
resolves here.

Each module defines CONFIG (exact assigned config) and optionally
RULE_OVERRIDES (per-arch logical→physical overrides, DESIGN.md §6), which
`launch/mesh.build_rules` applies over the base rules.
"""
from __future__ import annotations

import importlib

_ARCHS = {
    "granite-3-2b": "granite_3_2b",
    "nemotron-4-15b": "nemotron_4_15b",
    "minitron-8b": "minitron_8b",
    "mistral-large-123b": "mistral_large_123b",
    "paligemma-3b": "paligemma_3b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "xlstm-350m": "xlstm_350m",
    "hubert-xlarge": "hubert_xlarge",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
}

ARCH_IDS = tuple(_ARCHS)


def get_config(arch_id: str):
    if arch_id not in _ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(_ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[arch_id]}")
    return mod.CONFIG


def get_rule_overrides(arch_id: str) -> dict:
    mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[arch_id]}")
    return getattr(mod, "RULE_OVERRIDES", {})
