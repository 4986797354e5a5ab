"""The share of the traced window in which no device activity ran, in a
fleet cell."""


def read(s):
    if s.entry != "fleet" or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
