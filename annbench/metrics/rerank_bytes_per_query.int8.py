"""`core/search.py`'s rerank stage: the bytes of rerank rows and scales
it read per query of the traced slice (the program's `row_bytes` count on
"search.rerank": d + 4 a valid candidate from int8 rows, 4d a slot from
f32 rows). Nothing to read where the program keeps no such count."""
from annbench import counters

UNIT = "B/query"
SOURCE = "program_counter"


def read(ctx):
    return counters.per_query(ctx, "row_bytes")
