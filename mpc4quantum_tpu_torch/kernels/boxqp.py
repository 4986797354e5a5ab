"""Batched box-QP solves: the wrapper of the small-n CUDA kernel
csrc/boxqp_small.cu and its plain PyTorch version, the large-n solve
`boxqp_big` around the ADMM kernel of kernels/admm_big.py, and the
acceptance rule.

`boxqp_small` replaces mpc4quantum_tpu/ops/pallas_qp.py::_qp_kernel
(`boxqp_pallas` and `boxqp_accept` there), in its unscaled and its
Jacobi-scaled form; `boxqp_big` is the host side of `boxqp_pallas_big`. On
a CPU tensor the wrappers run the plain versions; on a CUDA tensor they
launch the kernels or raise.
"""

from __future__ import annotations

import torch

from ..solvers.boxqp import (BoxQPAux, BoxQPParams, FixedSolve, accept_rule,
                             solve_boxqp_fixed)
from . import _build
from .admm_big import admm_big

MAX_N = 16
# the rows of boxqp_small's aux buffer (csrc/boxqp_small.cu), BoxQPAux's fields
AUX_ROWS = 8


def _params(iters, rounds, rho_scale, sigma, alpha, eps_abs, eps_rel, acc_abs, acc_rel,
            **kw) -> BoxQPParams:
    return BoxQPParams(rho0=rho_scale, sigma=sigma, alpha=alpha, eps_abs=eps_abs,
                       eps_rel=eps_rel, max_iter=iters, n_rounds=rounds,
                       accept_abs=acc_abs, accept_rel=acc_rel, **kw)


def boxqp_small_work(B: int, n: int, iters: int, rounds: int, *, x0: bool = True,
                     y0: bool = True, rho0: bool = True):
    """The work of one `boxqp_small` call, counted from its shapes (FMA = 2
    flops): per lane rounds * (2n^3 Gauss-Jordan + iters (2n^2 + 8n) ADMM
    + 2n^2 + 12n residuals) flops, and 4 (n^2 + 7n + 9) bytes: P, q, lb, ub,
    x0, y0 and rho0 read once, z, y and the 8 aux rows written once, less
    4n (4 for rho0) for each warm start the call leaves out. The scaled
    form reads no more (the kernel forms d itself); its equilibration,
    ~2n^2 + 8n flops, is not counted.

    :return: (flops, bytes).
    """
    flops = rounds * (2 * n ** 3 + iters * (2 * n ** 2 + 8 * n) + 2 * n ** 2 + 12 * n)
    words = n * n + 5 * n + 8 + n * (bool(x0) + bool(y0)) + bool(rho0)
    return B * flops, 4 * B * words


def boxqp_small_ref(P, q, lb, ub, x0=None, y0=None, rho0=None, *, iters: int,
                    rounds: int, rho_scale: float = 0.1, sigma: float = 1e-6,
                    alpha: float = 1.6, eps_abs: float = 1e-6, eps_rel: float = 1e-6,
                    acc_abs: float = 1e-3, acc_rel: float = 1e-3, scale: bool = False):
    """Plain version of the kernel: solvers/boxqp.solve_boxqp_fixed with the
    Gauss-Jordan inverse, on any device and dtype.
    :return: (z (B, n), y (B, n), BoxQPAux)."""
    params = _params(iters, rounds, rho_scale, sigma, alpha, eps_abs, eps_rel, acc_abs,
                     acc_rel, kinv="gj", scale=scale)
    return solve_boxqp_fixed(P, q, lb, ub, x0=x0, y0=y0, rho0=rho0, params=params)[:3]


def boxqp_small(P, q, lb, ub, x0=None, y0=None, rho0=None, *, iters: int, rounds: int,
                rho_scale: float = 0.1, sigma: float = 1e-6, alpha: float = 1.6,
                eps_abs: float = 1e-6, eps_rel: float = 1e-6, acc_abs: float = 1e-3,
                acc_rel: float = 1e-3, scale: bool = False):
    """Solve B independent box QPs  min 1/2 x^T P x + q^T x, lb <= x <= ub.

    :param P: (B, n, n), n <= 16; q, lb, ub: (B, n).
    :param x0: optional (B, n) warm start; y0: optional (B, n) dual warm
        start (None = zeros), unscaled; rho0: optional (B,) penalty warm
        start in the solver's space, lanes <= 0 take the cold default
        rho_scale * mean(diag P).
    :param iters, rounds: ADMM steps per round and rounds with a rho
        rebalance between them.
    :param scale: Jacobi-equilibrate each QP (solvers/boxqp.jacobi_scale_boxqp)
        before the solve; z and y come back unscaled and the statistics in
        the original coordinates.
    :return: (z (B, n) box-feasible solution, y (B, n) final dual,
        BoxQPAux of (B,) residual statistics and the final rho).
    """
    kw = dict(iters=iters, rounds=rounds, rho_scale=rho_scale, sigma=sigma, alpha=alpha,
              eps_abs=eps_abs, eps_rel=eps_rel, acc_abs=acc_abs, acc_rel=acc_rel)
    if P.device.type == "cpu":
        return boxqp_small_ref(P, q, lb, ub, x0, y0, rho0, scale=scale, **kw)
    if P.device.type != "cuda":
        raise ValueError(f"boxqp_small: unsupported device {P.device}")
    B, n, n2 = P.shape
    if n != n2 or not 1 <= n <= MAX_N:
        raise ValueError(f"boxqp_small: P must be (B, n, n) with n <= {MAX_N}, got {tuple(P.shape)}")
    for t, name, shape in ((P, "P", (B, n, n)), (q, "q", (B, n)), (lb, "lb", (B, n)),
                           (ub, "ub", (B, n)), (x0, "x0", (B, n)), (y0, "y0", (B, n)),
                           (rho0, "rho0", (B,))):
        if t is not None and (t.device != P.device or t.dtype != torch.float32
                              or tuple(t.shape) != shape):
            raise ValueError(f"boxqp_small: {name} must be float32 {shape} on {P.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    # the kernel symmetrizes, scales and unscales itself: one launch a solve.
    # contiguous() is a no-op on the runner's tensors; the copies it makes of
    # others stay referenced here until the launch is queued
    P, q, lb, ub, x0, y0, rho0 = (None if t is None else t.contiguous()
                                  for t in (P, q, lb, ub, x0, y0, rho0))
    ptr = lambda t: None if t is None else t.data_ptr()
    z = torch.empty((B, n), dtype=torch.float32, device=P.device)
    y = torch.empty((B, n), dtype=torch.float32, device=P.device)
    aux = torch.empty((AUX_ROWS, B), dtype=torch.float32, device=P.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(P.device).cuda_stream
    rc = lib.mpc4q_boxqp_small(
        ptr(P), ptr(q), ptr(lb), ptr(ub), ptr(x0), ptr(y0), ptr(rho0), z.data_ptr(),
        y.data_ptr(), aux.data_ptr(), B, n, int(iters), int(rounds), int(scale), rho_scale,
        sigma, alpha, eps_abs, eps_rel, acc_abs, acc_rel, stream)
    _build.check(rc, "boxqp_small")
    boxqp_small.launches += 1
    return z, y, BoxQPAux(*aux.unbind(0))


boxqp_small.launches = 0


def boxqp_big(P, q, lb, ub, x0=None, y0=None, rho0=None, *, iters: int, rounds: int,
              rho_scale: float = 0.1, sigma: float = 1e-6, alpha: float = 1.6,
              eps_abs: float = 1e-6, eps_rel: float = 1e-6, acc_abs: float = 1e-3,
              acc_rel: float = 1e-3, scale: bool = False, kinv_method: str = "ns",
              ns_iters: int = 30, ns_refresh: int = 10, ns_guard: float = 0.9,
              ns_polish: int = 1, kinv0=None, lqr_data=None) -> FixedSolve:
    """Solve B box QPs of any size up to admm_big.MAX_N: the host side of
    `boxqp_pallas_big`, batched over lanes. Each round forms K = P +
    (sigma + rho) I, inverts it in plain torch, runs `iters` ADMM steps in
    one `admm_big` launch, and takes the residuals, the acceptance test and
    the rho rebalance (solvers/boxqp.solve_boxqp_fixed with the kernel as
    its ADMM loop).

    :param kinv_method: "gj", "ns" (`ns_iters` cold steps, or `ns_refresh`
        from `kinv0` under the `ns_guard` contraction guard), "riccati" or
        "riccati_pscan" (the exact inverse of `lqr_data`'s factorization
        and `ns_polish` steps on round 1, `ns_refresh` on later rounds).
    :param kinv0: optional (B, n, n) K-inverse carried from the previous
        solve (its FixedSolve.kinv).
    :param lqr_data: the real-embedded LTV problem that built P
        (solve_boxqp_fixed), for the Riccati methods.
    Other arguments as `boxqp_small`; the returned rho stays in the
    solver's space.
    :return: FixedSolve (z, y, aux, the last round's K-inverse, the lanes
        whose carried inverse fell back to the cold init).
    """
    params = _params(iters, rounds, rho_scale, sigma, alpha, eps_abs, eps_rel, acc_abs,
                     acc_rel, kinv=kinv_method, ns_iters=ns_iters, ns_refresh=ns_refresh,
                     ns_guard=ns_guard, ns_polish=ns_polish, scale=scale)
    return solve_boxqp_fixed(P, q, lb, ub, x0=x0, y0=y0, rho0=rho0, params=params,
                             kinv0=kinv0, lqr_data=lqr_data, admm=admm_big)


def boxqp_accept(aux: BoxQPAux, eps_abs: float, eps_rel: float,
                 accept_abs: float, accept_rel: float) -> torch.Tensor:
    """The solver's acceptance rule on a solve's statistics: (B,) bool."""
    return accept_rule(*aux[:7], eps_abs, eps_rel, accept_abs, accept_rel)
