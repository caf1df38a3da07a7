"""SOAR core (PyTorch port of `repro/core`): VQ training, spilled
assignment, IVF assembly, flat and tree probe routers, filtered
candidate-local search (fixed-budget and host engines), the mutable
index, ground truth and the KMR metrics."""
from repro_torch.core.build import (assign_shards, build_ivf_sharded,  # noqa: F401
                                    spill_plan, train_codebook)
from repro_torch.core.ivf import IVFIndex, build_ivf, finalize_ivf  # noqa: F401
from repro_torch.core.kmeans import (assign_euclidean,  # noqa: F401
                                     assign_euclidean_topk, train_kmeans)
from repro_torch.core.kmr import (KMRCurve, kmr_curve, points_to_recall,  # noqa: F401
                                  rank_statistics, recall_at_k, true_neighbors)
from repro_torch.core.mutable import EpochLRU, MutableIVF  # noqa: F401
from repro_torch.core.router import (FlatRouter, TreeRouter, as_router,  # noqa: F401
                                     clamp_top_t, train_tree_router)
from repro_torch.core.search import (PackedIVF, SearchStats, pack_ivf,  # noqa: F401
                                     search_jit, search_jit_batched, search_numpy)
from repro_torch.core.soar import (naive_spill_assign, soar_assign,  # noqa: F401
                                   soar_assign_multi)
