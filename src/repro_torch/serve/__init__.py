"""Serving (PyTorch port of `repro/serve`): the request API, the LM
decode engine, the online ANN engine over a mutable index, the serving
front-end with its tenant filters and health breakers, and the kNN
attention memory."""
from repro_torch.serve.api import (SearchParams, SearchResult,  # noqa: F401
                                   validate_queries)
from repro_torch.serve.engine import (AnnEngine, ServeEngine,  # noqa: F401
                                      make_prefill_step, make_serve_step)
from repro_torch.serve.frontend import (ServingFrontend,  # noqa: F401
                                        TenantFilterBank, UnknownTenantError)
from repro_torch.serve.health import (CircuitBreaker,  # noqa: F401
                                      HealthTracker, shards_ok_from_mask)
from repro_torch.serve.knn_memory import (KNNMemory,  # noqa: F401
                                          exact_topk_attention)
