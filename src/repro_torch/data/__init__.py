"""Synthetic datasets (PyTorch port of `repro/data`)."""
from repro_torch.data.vectors import (VectorDataset, glove_like,  # noqa: F401
                                      make_clustered, make_manifold, make_uniform)
