"""LM models (PyTorch port of `repro/models`): configs, parameter
definitions, layers, attention, MoE, recurrent mixers and the assembled
transformer."""
from repro_torch.models.config import (SHAPES, ModelConfig, ShapeCell,  # noqa: F401
                                       cell_applicable)
from repro_torch.models import transformer  # noqa: F401
