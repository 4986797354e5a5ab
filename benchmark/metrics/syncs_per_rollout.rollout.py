"""Stream, event and device synchronizations plus device-to-host copies,
per `mpc()` rollout: the host's reads of device flags."""


def read(s):
    if s.entry != "rollout" or not s.rollouts:
        return None
    return s.syncs / s.rollouts
