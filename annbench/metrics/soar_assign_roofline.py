"""`kernels/soar_assign.py` → `csrc/soar_assign.cu`: the SOAR spill
kernel's device time in the traced slice against the least work of
spilling every row once a build (`roofline.soar_assign`)."""
from annbench import roofline, work

UNIT = "%"
SOURCE = "device_trace"


def soar(name: str) -> bool:
    """assign_kernel<BM, SOAR, RESIDENT> with SOAR true."""
    if "assign_kernel<" not in name:
        return False
    args = name.split("assign_kernel<", 1)[1].split(">", 1)[0].split(",")
    return len(args) > 1 and args[1].strip() == "true"


def read(ctx):
    X = ctx.state["v"].X
    n, d = X.shape
    c = ctx.cfg["index"]["n_partitions"]
    return work.kernel_share(ctx, soar, roofline.soar_assign(n, c, d),
                             ctx.trace_rec["builds"])
