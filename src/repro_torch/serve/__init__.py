"""Serving (PyTorch port of `repro/serve`): the request API and the online
ANN engine over a mutable index."""
from repro_torch.serve.api import (SearchParams, SearchResult,  # noqa: F401
                                   validate_queries)
from repro_torch.serve.engine import AnnEngine  # noqa: F401
