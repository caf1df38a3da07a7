"""`kernels/lloyd.py` → `csrc/lloyd.cu`: the Lloyd sweeps' device time in
the traced slice (each sweep's nearest-centroid tile loop, the launch of
`assign_kernel<.., false, ..>` that a `group_hist_kernel` follows, and its
grouping kernels) against the least work of a sweep over the codebook's
training sample (`roofline.lloyd_sweep`) times the sweeps run."""
from annbench import roofline

UNIT = "%"
SOURCE = "device_trace"


def _nearest(name: str) -> bool:
    if "assign_kernel<" not in name:
        return False
    args = name.split("assign_kernel<", 1)[1].split(">", 1)[0].split(",")
    return len(args) > 1 and args[1].strip() == "false"


def read(ctx):
    ks = [(n, d) for n, _, d in ctx.tr.kernels
          if _nearest(n) or "group_" in n and "_kernel" in n]
    t, sweeps = 0.0, 0
    for i, (name, dur) in enumerate(ks):
        if "group_" in name:
            t += dur
            sweeps += "group_hist_kernel" in name
        elif i + 1 < len(ks) and "group_hist_kernel" in ks[i + 1][0]:
            t += dur
    if sweeps == 0 or t <= 0:
        return None
    n, d = ctx.state["v"].X.shape
    ix = ctx.cfg["index"]
    n_train = min(int(ix.get("train_sample") or n), n)
    sweep = roofline.lloyd_sweep(n_train, ix["n_partitions"], d)
    return roofline.share_pct(sweep.scaled(sweeps), t)
