"""`kernels/pq_score.py::pq_score_probes`: the probe scorer's device time
in the traced slice against the least work of scoring every query's probed
partitions (`roofline.probe_scoring`) over the slice's passes."""
from annbench import work

UNIT = "%"
SOURCE = "device_trace"


def read(ctx):
    return work.kernel_share(ctx, lambda n: "pq_score_probes_kernel" in n,
                             work.batch_pass(ctx)["probe"], ctx.trace_rec["passes"])
