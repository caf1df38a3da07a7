"""PyTorch + CUDA port of the SOAR reproduction (`src/repro/`, the JAX
package, is the reference it is tested against).

The layout mirrors `repro` (core/, kernels/, quant/, data/). The kernels of
the main path are hand-written CUDA for Hopper (`csrc/`), built with nvcc
at first use; each has a plain PyTorch version that CPU tensors take.
Entry points run on CUDA unless the caller passes device="cpu".
"""
