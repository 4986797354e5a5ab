"""The yardstick of the kernel layer: the work of each hand-written
kernel's function counted from its shapes, the chip's published peaks,
and the solve schedule a configuration's budgets imply.

The formulas are frozen copies of the program's own (kernels/boxqp.py
`boxqp_small_work`, kernels/admm_big.py `admm_big_work` and `stream_bytes`,
kernels/expm.py `expm_small_work`) as they stood when the benchmark was
defined; a CPU test holds them equal. A later change to the program's
copies does not move the benchmark's.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3 rate
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def boxqp_small_work(B: int, n: int, iters: int, rounds: int, *, x0: bool = True,
                     y0: bool = True, rho0: bool = True):
    """One small-n box-QP solve: per lane rounds * (2n^3 Gauss-Jordan +
    iters (2n^2 + 8n) ADMM + 2n^2 + 12n residuals) flops; P, q, lb, ub and
    the warm starts given read once, z, y and 8 statistics written once
    (4-byte words). :return: (flops, bytes)."""
    flops = rounds * (2 * n ** 3 + iters * (2 * n ** 2 + 8 * n) + 2 * n ** 2 + 12 * n)
    words = n * n + 5 * n + 8 + n * (bool(x0) + bool(y0)) + bool(rho0)
    return B * flops, 4 * B * words


def admm_big_work(B: int, n: int, iters: int):
    """`iters` ADMM steps from a given K^-1: per lane iters (2n^2 + 8n)
    flops; K^-1, q, lb, ub, x, z, y, rho read once, x, z, y written once.
    :return: (flops, bytes)."""
    return B * iters * (2 * n * n + 8 * n), 4 * B * (n * n + 9 * n + 1)


def stream_bytes(B: int, n: int, iters: int) -> int:
    """The bytes of a call that reads K^-1 every iteration."""
    return 4 * B * (iters * n * n + 9 * n + 1)


def taylor_products(taylor_k: int) -> int:
    """The least matrix products of a degree-taylor_k polynomial
    (Paterson-Stockmeyer)."""
    return min(p + -(-taylor_k // p) - 2 for p in range(1, max(taylor_k, 1) + 1))


def expm_small_work(B: int, d: int, taylor_k: int, squarings: int = 0):
    """exp of B complex d x d matrices: the Taylor polynomial's least
    products at 8d^3 flops, 2d^2 a coefficient, the squarings the call
    takes in all; complex64 in and out. :return: (flops, bytes)."""
    taylor = taylor_products(taylor_k) * 8 * d ** 3 + taylor_k * 2 * d * d
    return B * taylor + squarings * 8 * d ** 3, 16 * d * d * B


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take for this work."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def fleet_solves(config: dict, B: int):
    """The QP solves of one fleet run as its budgets give them: [(lanes,
    rounds, iters, warm start given)], warm steps first. Every lane runs
    every solve (a fleet run has no early exit)."""
    bud = config["budgets"]["fleet"]
    warm, steady = bud["warm_qp"], bud["steady_qp"]
    wi = bud["warm_iters"]
    out = []
    for step in range(config["n_steps"]):
        if step <= 1:
            out += [(B, warm["rounds"], warm["iters"], False)] * wi[min(step, len(wi) - 1)]
        else:
            out.append((B, steady["rounds"], steady["iters"], bud["carry_duals"]))
    return out


def qp_schedule(config: dict, batches) -> dict:
    """The launches and the work of each QP function over fleet runs of the
    given lane batches: {function: (launches, flops, bytes)}. n <= 16 is the
    small route (one launch a solve), above it the ADMM route (one launch a
    round)."""
    n = config["horizon"] * len(config["controls"])
    fn = "qp_small" if n <= 16 else "qp_admm"
    launches = flops = nbytes = 0
    for B in batches:
        for lanes, rounds, iters, seeded in fleet_solves(config, B):
            if fn == "qp_small":
                f, b = boxqp_small_work(lanes, n, iters, rounds, x0=True, y0=seeded, rho0=seeded)
                launches += 1
            else:
                f, b = admm_big_work(lanes, n, iters)
                f, b = f * rounds, b * rounds
                launches += rounds
            flops += f
            nbytes += b
    return {fn: (launches, flops, nbytes)}

