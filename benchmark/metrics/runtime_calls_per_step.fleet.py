"""CUDA runtime and driver calls that put work on the device (kernel and
graph launches, copies, sets), per MPC step of a fleet run: the host step
loop's dispatch."""


def read(s):
    if s.entry != "fleet" or not s.steps:
        return None
    return s.runtime_calls / s.steps
