"""The share of the MPC steps of a window's `mpc()` rollouts that ran as
CUDA-graph replays (the span fleet.step with the attribute graph "replay",
from mpc/step_graphs.py), in percent; nothing where no step carries the
attribute (a program that captures nothing)."""

from benchmark.metrics import _spans


def read(s):
    if s.entry != "rollout" or not s.rollouts:
        return None
    steps = _spans.named(s, "fleet.step")
    if not steps or not any(sp.attrs and "graph" in sp.attrs for sp in steps):
        return None
    return 100.0 * sum(bool(sp.attrs) and sp.attrs.get("graph") == "replay"
                       for sp in steps) / len(steps)
