"""SQP iterations per `mpc()` rollout (the count of the span sqp.iter,
FleetRunner._sqp_iter): the warm steps' line-searched iterations until
the done flag holds, and one a steady step."""

from benchmark.metrics import _spans


def read(s):
    if s.entry != "rollout" or not s.rollouts:
        return None
    iters = _spans.named(s, "sqp.iter")
    if not iters:
        return None
    return len(iters) / s.rollouts
