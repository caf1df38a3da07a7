"""`core/kmeans.py`'s k-means++ seeding of the codebook: the host seconds
of the program's "kmeans.seed" spans over those of its "build" spans in
the traced slice (`annbench/spans.py`)."""
from annbench import spans

UNIT = "%"
SOURCE = "program_span"


def read(ctx):
    return spans.share_pct(ctx, "kmeans.seed", "build")
