"""Stream milliseconds per MPC step of a fleet run in the K^-1 builds of
the boxqp_big route (the span qp.kinv, one a rho round, whichever method):
the time between each span's two CUDA events, the device's waits for the
host inside it included. Nothing where no step built a K^-1 on the host
side (boxqp_small inverts inside its kernel)."""

from benchmark.metrics import _spans


def read(s):
    return _spans.stream_ms_per_step(s, "qp.kinv")
