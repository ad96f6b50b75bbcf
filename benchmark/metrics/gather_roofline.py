"""Kernel B's share of its roofline: the least time its gather at the crop
takes (harness/roofline.py) over the device time the trace gives each
launch of `gather_rows`."""

from harness import roofline


def read(ctx):
    tr = ctx["tracer"]
    if tr is None:
        return None
    n, secs = tr.kernel_time("gather_rows")
    if n == 0 or secs <= 0:
        return None
    return 100.0 * roofline.gather_bound_s(ctx["cfg"]) * n / secs
