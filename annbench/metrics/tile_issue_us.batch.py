"""`core/search.py`'s tile chain: the mean host microseconds of the
program's "search.tile" spans in the traced slice, the time the host takes
to issue one tile's launches (no span inside a tile waits for the
device)."""
from annbench import spans

UNIT = "us"
SOURCE = "program_span"


def read(ctx):
    return spans.mean_us(ctx, "search.tile")
