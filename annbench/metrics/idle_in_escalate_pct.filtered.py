"""`core/search.py`'s escalation steps: the device's idle seconds of the
traced slice while the host was inside one of the program's
"search.escalate" spans (a step's route, scoring, dedup and rerank of the
thin rows, and the wait for which rows stay thin), over the slice's
seconds (`annbench/spans.py`)."""
from annbench import spans

UNIT = "%"
SOURCE = "program_span"


def read(ctx):
    return spans.idle_within_pct(ctx, "search.escalate")
