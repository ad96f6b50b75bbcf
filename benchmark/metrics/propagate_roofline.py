"""Kernel A's share of its roofline: the least time its work at the crop
takes (harness/roofline.py) over the device time the trace gives each
launch of `propagate_kernel`."""

from harness import roofline


def read(ctx):
    tr = ctx["tracer"]
    if tr is None:
        return None
    n, secs = tr.kernel_time("propagate_kernel")
    if n == 0 or secs <= 0:
        return None
    return 100.0 * roofline.propagate_bound_s(ctx["cfg"]) * n / secs
