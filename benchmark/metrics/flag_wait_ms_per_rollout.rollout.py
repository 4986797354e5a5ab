"""Host milliseconds per `mpc()` rollout spent in the reads of the done
flags (the span host.flag in utils/profiling.host_flag): the wait for the
queued work and the copy back."""

from benchmark.metrics import _spans


def read(s):
    if s.entry != "rollout" or not s.rollouts:
        return None
    flags = _spans.named(s, "host.flag")
    if flags is None:
        return None
    return sum(sp.host_ms for sp in flags) / s.rollouts
