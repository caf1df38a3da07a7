"""The program's counts of the traced slice, per query: a count that the
program's spans (`repro_torch.spans`) carry, summed over every span that
has it, over the queries of its "engine.search_request" spans. Nothing to
read (None) where the program keeps no such count."""
from __future__ import annotations

from typing import Optional

from annbench import spans


def per_query(ctx, key: str) -> Optional[float]:
    r = spans.reading(ctx)
    if r is None:
        return None
    got = [p.counts[key] for p in r.spans if key in p.counts]
    queries = sum(p.counts.get("queries", 0) for p in r.spans
                  if p.name == "engine.search_request")
    if not got or queries <= 0:
        return None
    return sum(got) / queries
