"""Hand-written CUDA kernels of the port (built from `../csrc` at first use)
and their plain PyTorch versions (`ref.py`)."""
