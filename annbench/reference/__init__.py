"""Plain PyTorch references of the benchmark (float32, TF32 off).

They import nothing of the program. Where a reference follows the program
from the index it built (its codebooks, partitions and router), it works
every score, route, dedup and rerank out again itself; each cell judges
that index apart against its own inputs: the assignments and codes
(`build.py`), the router's tables (`router.py`) and, in the build cell,
the codebooks' training against the reference's own.
"""
