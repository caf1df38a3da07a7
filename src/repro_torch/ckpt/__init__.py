"""Durable index state (PyTorch port of `repro/ckpt`, DESIGN.md §3.11):
snapshots (index_store.py), the mutation log (wal.py) and crash injection
(faults.py). Both packages write format v1, so a snapshot or a log
written by either opens in the other."""
from repro_torch.ckpt.index_store import (CorruptSnapshotError, load_shards,
                                          load_snapshot, save_shards,
                                          save_snapshot)
from repro_torch.ckpt.wal import MutationWAL

__all__ = ["CorruptSnapshotError", "MutationWAL", "load_shards",
           "load_snapshot", "save_shards", "save_snapshot"]
