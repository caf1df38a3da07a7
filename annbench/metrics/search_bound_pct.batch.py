"""The whole search pass's share of its roofline: the least time of one
pass over every query (`roofline.search_pass`: route, probed partitions and
rerank rows read once, LUT, rerank and routing products, one add a code
byte) over the mean pass time of the measured window. It still bounds a
search gain after a later change takes a kernel off the path."""
from annbench import roofline, work

UNIT = "%"
SOURCE = "host_clock"


def read(ctx):
    rec = ctx.rec
    return roofline.share_pct(work.batch_pass(ctx)["pass"],
                                   rec["elapsed_s"] / rec["passes"])
