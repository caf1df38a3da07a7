"""`core/router.py::TreeRouter` → `kernels/tree_route.py`: the tree route
kernel's device time in the traced slice against the least work of the
two-level route of every query (`roofline.tree_route`) over the slice's
passes. Nothing to read on a flat index."""
from annbench import work

UNIT = "%"
SOURCE = "device_trace"


def read(ctx):
    route = work.batch_pass(ctx)["route"]
    if route is None:
        return None
    return work.kernel_share(ctx, lambda n: "tree_route_kernel" in n, route,
                             ctx.trace_rec["passes"])
