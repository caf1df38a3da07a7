"""Command-line entry points (PyTorch port of `repro/launch`)."""
