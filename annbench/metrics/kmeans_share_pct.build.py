"""`core/kmeans.py` (the codebook: k-means++ seeding and Lloyd sweeps):
its share of a build, from the program's own synchronised phase timings
(`build_ivf_sharded(timings=)`), averaged over the window's builds."""
UNIT = "%"
SOURCE = "program_span"


def read(ctx):
    shares = [100.0 * t["kmeans"] / sum(t.values()) for t in ctx.rec["timings"]
              if t.get("kmeans") and sum(t.values()) > 0]
    return sum(shares) / len(shares) if shares else None
