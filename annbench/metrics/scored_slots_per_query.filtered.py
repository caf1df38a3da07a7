"""`core/search.py`'s filtered search under `escalate="budget"`: the slots
that reach the probe scorer and the dedup per query of the traced slice,
summed over each query's passes (the program's `scored` counts: the
eligible slots of the probed partitions alone). Nothing to read where the
program keeps no such count."""
from annbench import counters

UNIT = "slots/query"
SOURCE = "program_counter"


def read(ctx):
    return counters.per_query(ctx, "scored")
