"""The device's idle share of the traced slice: the time in which no
kernel, copy or fill ran, from `torch.profiler`'s trace."""
from annbench import work

UNIT = "%"
SOURCE = "device_trace"


def read(ctx):
    return work.idle_pct(ctx)
