"""`core/search.py`'s tile chain: the device's idle seconds of the traced
slice while the host was inside one of the program's "search.tile" spans
(a tile's route, gather, LUT, scoring, dedup and rerank), over the slice's
seconds (`annbench/spans.py`). `idle_pct.batch` less this is the idle time
outside the tiles: the engine's copies and the gaps between calls."""
from annbench import spans

UNIT = "%"
SOURCE = "program_span"


def read(ctx):
    return spans.idle_within_pct(ctx, "search.tile")
