"""The share of a fleet window's condensings that ran as the one kernel
launch of kernels/condense.condense_small (the span qp.condense with the
attribute route "kernel", from mpc/fleet_runner.py), in percent; 0 where
every one ran the plain ops (route "plain"); nothing where no condensing
carries the attribute (a program without the kernel)."""

from benchmark.metrics import _spans


def read(s):
    if s.entry != "fleet":
        return None
    condense = _spans.named(s, "qp.condense")
    if not condense or not any(sp.attrs and "route" in sp.attrs for sp in condense):
        return None
    return 100.0 * sum(bool(sp.attrs) and sp.attrs.get("route") == "kernel"
                       for sp in condense) / len(condense)
