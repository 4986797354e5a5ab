"""Device milliseconds per MPC step of a fleet run in activities that no
hand-written kernel of the kernel map implements: the plain PyTorch of
linearize, condense, the K^-1 builds, the driver's updates and copies."""


def read(s):
    if s.entry != "fleet" or not s.steps:
        return None
    return s.fn_device_s.get(None, 0.0) / s.steps * 1e3
