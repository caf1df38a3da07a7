"""`core/search.py`'s filtered search under `escalate="budget"`: the
partitions probed per query of the traced slice, summed over each query's
passes (the program's `probed` counts on its "search.tile" and
"search.escalate" spans, over the `queries` of its "engine.search_request"
spans). Nothing to read where the program keeps no such count."""
from annbench import counters

UNIT = "probes/query"
SOURCE = "program_counter"


def read(ctx):
    return counters.per_query(ctx, "probed")
