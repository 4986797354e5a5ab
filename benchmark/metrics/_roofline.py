"""A QP function's share of its roofline: the least time its work could
take at the chip's peaks over the device time of the kernels that
implement it. None where the window ran none of them, or ran another
number of launches than the budgets imply (the work would not be the one
timed)."""

from benchmark.work import bound_s


def share(s, fn):
    t = s.fn_device_s.get(fn, 0.0)
    if fn not in s.schedule or t <= 0:
        return None
    launches, flops, nbytes = s.schedule[fn]
    if s.fn_launches.get(fn, 0) != launches:
        return None
    return 100.0 * bound_s(flops, nbytes) / t
