"""Stream milliseconds per MPC step of a fleet run in the linearization and
the condensing (the spans sqp.linearize and qp.condense): the time between
each span's two CUDA events. Where the device sets the pace it is the
phases' device time; where the host does, it also holds the gaps in which
the device waited for the host inside them. Not busy time."""

from benchmark.metrics import _spans


def read(s):
    return _spans.stream_ms_per_step(s, "sqp.linearize", "qp.condense")
