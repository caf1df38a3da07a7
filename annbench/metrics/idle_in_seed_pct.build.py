"""`core/kmeans.py`'s k-means++ seeding of the codebook: the device's idle
seconds of the traced slice while the host was inside the program's
"kmeans.seed" span, over the slice's seconds (`annbench/spans.py`)."""
from annbench import spans

UNIT = "%"
SOURCE = "program_span"


def read(ctx):
    return spans.idle_within_pct(ctx, "kmeans.seed")
