"""Stream milliseconds per MPC step of a fleet run in the plant step (the
span plant.step: the propagator's expm_small launch and the state's
conjugation): the time between the span's two CUDA events, the device's
waits for the host inside it included."""

from benchmark.metrics import _spans


def read(s):
    return _spans.stream_ms_per_step(s, "plant.step")
