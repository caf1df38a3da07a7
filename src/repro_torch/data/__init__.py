"""Synthetic datasets (PyTorch port of `repro/data`)."""
from repro_torch.data.vectors import VectorDataset, make_manifold  # noqa: F401
