"""The share of a fleet window's K^-1 builds that ran as the one kernel
launch of kernels/nsinv.ns_cold (the span qp.kinv with the attribute route
"kernel", from solvers/boxqp.solve_boxqp_fixed), in percent; 0 where every
one ran in plain PyTorch (route "plain"); nothing where no build carries
the attribute (a program without the kernel)."""

from benchmark.metrics import _spans


def read(s):
    if s.entry != "fleet":
        return None
    kinv = _spans.named(s, "qp.kinv")
    if not kinv or not any(sp.attrs and "route" in sp.attrs for sp in kinv):
        return None
    return 100.0 * sum(bool(sp.attrs) and sp.attrs.get("route") == "kernel"
                       for sp in kinv) / len(kinv)
