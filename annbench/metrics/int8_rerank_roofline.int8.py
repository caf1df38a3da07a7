"""`kernels/int8_rerank.py` → `csrc/int8_rerank.cu`: the int8 rerank
kernel's device time in the traced slice against the least work of the
slice's passes (`least_work`)."""
from annbench import roofline, work

UNIT = "%"
SOURCE = "device_trace"


def least_work(nq: int, budget: int, d: int, k: int) -> roofline.Work:
    """The rerank of one pass: nq·budget candidates, each one's row of d
    int8 codes and its f32 scale (d + 4 bytes) and its int32 id read once,
    each f32 query read once, k int32 ids and f32 scores a query written;
    2d f32 operations a candidate (a multiply-add an element, on the CUDA
    cores)."""
    cand = nq * budget
    return roofline.Work(cand * (d + 4 + 4) + nq * d * 4 + nq * k * 8,
                         ops=2.0 * cand * d)


def read(ctx):
    nq, d = ctx.state["v"].Q.shape
    w = least_work(nq, ctx.cfg["engine"]["rerank_budget"], d, ctx.cfg["search"]["k"])
    return work.kernel_share(ctx, lambda n: "int8_rerank" in n, w, ctx.trace_rec["passes"])
