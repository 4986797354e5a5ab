"""The share of its roofline that the qp_admm function reaches (see _roofline)."""

from benchmark.metrics._roofline import share


def read(s):
    return share(s, "qp_admm")
