"""The mean host duration of one MPC step of a fleet run: the span
fleet.step (FleetRunner.step), enqueue and any wait inside it."""

from benchmark.metrics import _spans


def read(s):
    if s.entry != "fleet":
        return None
    steps = _spans.named(s, "fleet.step")
    if not steps:
        return None
    return sum(sp.host_ms for sp in steps) / len(steps)
