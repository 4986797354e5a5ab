"""Fixed-budget ADMM for batches of box QPs (counterpart of
mpc4quantum_tpu/solvers/boxqp.py `solve_boxqp_fixed`, with the `kinv="gj"`
and cold `kinv="ns"` inverses and the Jacobi-scaled form).

Solves, per lane b,  min 1/2 x^T P_b x + q_b^T x  s.t.  lb_b <= x <= ub_b
with `n_rounds` rounds of exactly `max_iter` relaxed OSQP-style iterations:

    x~ = (P + (sigma+rho) I)^{-1} (sigma x - q + rho z - y)
    z  = clip(alpha x~ + (1-alpha) z + y/rho, lb, ub)
    y  = y + rho (alpha x~ + (1-alpha) z_old - z)

with the inverse taken each round by unpivoted Gauss-Jordan or by a cold
Newton-Schulz chain, and rho rebalanced between rounds by the OSQP residual
rule, frozen once the round passes the acceptance test. With `scale` the QP
is solved in Jacobi-equilibrated coordinates and the residuals are reported
in the original ones. This is the plain version of both box-QP kernels
(kernels/boxqp.py): the same algorithm in the same order.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from ..utils.linalg import gj_inverse

KINV_METHODS = ("gj", "ns")


@dataclasses.dataclass(frozen=True)
class BoxQPParams:
    rho0: float = 0.1
    sigma: float = 1e-6
    alpha: float = 1.6
    eps_abs: float = 1e-6
    eps_rel: float = 1e-6
    max_iter: int = 150
    n_rounds: int = 2
    # acceptance thresholds: a solve is declared failed only beyond these
    accept_abs: float = 1e-3
    accept_rel: float = 1e-3
    # Newton-Schulz iterations of the "ns" K-inverse
    ns_iters: int = 30
    # K-inverse of each round: "gj" Gauss-Jordan, "ns" cold Newton-Schulz
    kinv: str = "ns"
    # Jacobi equilibration: solve in x' = x / d, d = diag(P)^-1/2
    scale: bool = False


class BoxQPAux(NamedTuple):
    """Per-lane (B,) residual statistics of a solve, in the kernel's aux row
    order: final primal/dual residuals, the inf-norm scalings, and the final
    (post-rebalance) rho - the warm value for the next solve. With `scale`
    the statistics are in the original coordinates and rho stays in the
    solver's (scaled) space."""

    prim: torch.Tensor
    dual: torch.Tensor
    xmax: torch.Tensor
    zmax: torch.Tensor
    pxmax: torch.Tensor
    qmax: torch.Tensor
    ymax: torch.Tensor
    rho: torch.Tensor


def accept_thresholds(xmax, zmax, pxmax, qmax, ymax,
                      eps_abs: float, eps_rel: float, acc_abs: float, acc_rel: float):
    """Per-lane (primal, dual) residual thresholds: the OSQP relative
    tolerances, loosened to the acceptance thresholds."""
    pscale = torch.maximum(xmax, zmax)
    dscale = torch.maximum(pxmax, torch.maximum(qmax, ymax))
    return (torch.maximum(eps_abs + eps_rel * pscale, acc_abs + acc_rel * pscale),
            torch.maximum(eps_abs + eps_rel * dscale, acc_abs + acc_rel * dscale))


def accept_rule(prim, dual, xmax, zmax, pxmax, qmax, ymax,
                eps_abs: float, eps_rel: float, acc_abs: float, acc_rel: float):
    """(B,) bool: both residuals within their thresholds. A NaN residual is
    never accepted."""
    tol_p, tol_d = accept_thresholds(xmax, zmax, pxmax, qmax, ymax,
                                     eps_abs, eps_rel, acc_abs, acc_rel)
    return (prim <= tol_p) & (dual <= tol_d)


def warm_rho(rho0, default, diag_scale):
    """rho0 > 0 takes the carried penalty (clipped to the adaptation range);
    rho0 <= 0 is the sentinel for the cold default."""
    if rho0 is None:
        return default
    warm = torch.clamp(rho0, 1e-8 * diag_scale, 1e8 * diag_scale)
    return torch.where(rho0 > 0, warm, default)


def jacobi_scale_boxqp(P, q, lb, ub, x0=None, y0=None):
    """Jacobi-equilibrate a batch of box QPs: x = d * x', d = diag(P)^-1/2.

    :return: (P', q', lb', ub', x0', y0', d) with P' = D P D (unit
        diagonal), q' = d q, lb' = lb / d, x0' = x0 / d and the dual
        y0' = d y0. Unscale a solution with x = d x', y = y' / d.
    """
    dg = torch.diagonal(P, dim1=-2, dim2=-1)
    d = 1.0 / torch.sqrt(torch.clamp(dg, min=1e-12))
    Ps = P * d[..., :, None] * d[..., None, :]
    return (Ps, q * d, lb / d, ub / d, None if x0 is None else x0 / d,
            None if y0 is None else y0 * d, d)


def ns_inverse(K, iters: int = 30, X0=None):
    """Inverse of a batch of SPD matrices (..., n, n) by the cold
    Newton-Schulz iteration X <- X (2I - K X) from X = K^T / (||K||_1
    ||K||_inf), which contracts for SPD K. Matmuls only."""
    if X0 is not None:
        raise NotImplementedError("the warm-started Newton-Schulz inverse (X0) is not ported")
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    n1 = K.abs().sum(dim=-2).amax(dim=-1)
    ninf = K.abs().sum(dim=-1).amax(dim=-1)
    X = K.transpose(-1, -2) / (n1 * ninf)[..., None, None]
    for _ in range(iters):
        X = X @ (2.0 * eye - K @ X)
    return X


def _clip(v, lb, ub):
    return torch.minimum(torch.maximum(v, lb), ub)


def _maxabs(v):
    return v.abs().amax(dim=-1)


def admm_iters(Kinv, q, lb, ub, rho, x, z, y, *, iters: int, sigma: float, alpha: float):
    """`iters` relaxed ADMM steps from a given K^-1 (B, n, n) and rho (B,):
    the inner loop of every round. :return: (x, z, y), each (B, n)."""
    r = rho[:, None]
    for _ in range(iters):
        x = (Kinv @ (sigma * x - q + r * z - y)[..., None])[..., 0]
        z_arg = alpha * x + (1 - alpha) * z
        z_new = _clip(z_arg + y / r, lb, ub)
        y = y + r * (z_arg - z_new)
        z = z_new
    return x, z, y


def solve_boxqp_fixed(P, q, lb, ub, x0=None, y0=None, rho0=None,
                      params: BoxQPParams | None = None, kinv0=None, lqr_data=None,
                      admm: Optional[Callable] = None):
    """Batched fixed-budget ADMM.

    :param P: (B, n, n) PSD (symmetrized here); q, lb, ub: (B, n).
    :param x0: optional (B, n) warm start, clipped into the box.
    :param y0: optional (B, n) dual warm start (None = zeros), unscaled.
    :param rho0: optional (B,) penalty warm start in the solver's space;
        lanes <= 0 take the cold default rho0 * mean(diag P).
    :param kinv0, lqr_data: the K-inverse carry and the Riccati inverse of
        the reference; not ported, they raise.
    :param admm: the ADMM inner loop, with the signature of `admm_iters`
        (the default); kernels/boxqp.boxqp_big passes the CUDA kernel.
    :return: (z (B, n) box-feasible solution, y (B, n) dual, BoxQPAux).
    """
    params = BoxQPParams() if params is None else params
    if kinv0 is not None or lqr_data is not None:
        raise NotImplementedError("the K-inverse carry (kinv0) and the Riccati inverse "
                                  "(lqr_data) are not ported")
    if params.kinv not in KINV_METHODS:
        raise NotImplementedError(f"kinv={params.kinv!r} is not ported; use one of {KINV_METHODS}")
    admm = admm_iters if admm is None else admm
    B, n = q.shape
    P = 0.5 * (P + P.transpose(-1, -2))
    d = None
    if params.scale:
        P, q, lb, ub, x0, y0, d = jacobi_scale_boxqp(P, q, lb, ub, x0, y0)
    # residual rows in the original coordinates: primal rows * d, dual / d
    wp = (lambda v: v) if d is None else (lambda v: d * v)
    wd = (lambda v: v) if d is None else (lambda v: v / d)
    eye = torch.eye(n, dtype=P.dtype, device=P.device)
    diag_scale = torch.clamp(torch.diagonal(P, dim1=-2, dim2=-1).mean(dim=-1), min=1e-12)
    rho = warm_rho(rho0, params.rho0 * diag_scale, diag_scale)
    x = _clip(torch.zeros_like(q) if x0 is None else x0, lb, ub)
    z = x
    y = torch.zeros_like(q) if y0 is None else y0
    qmax = _maxabs(wd(q))
    sigma = params.sigma
    for _ in range(params.n_rounds):
        K = P + (sigma + rho)[:, None, None] * eye
        Kinv = gj_inverse(K) if params.kinv == "gj" else ns_inverse(K, params.ns_iters)
        x, z, y = admm(Kinv, q, lb, ub, rho, x, z, y, iters=params.max_iter, sigma=sigma,
                       alpha=params.alpha)
        Px = (P @ x[..., None])[..., 0]
        stats = (_maxabs(wp(x - z)), _maxabs(wd(Px + q + y)), _maxabs(wp(x)), _maxabs(wp(z)),
                 _maxabs(wd(Px)), qmax, _maxabs(wd(y)))
        prim, dual, xmax, zmax, pxmax, _, ymax = stats
        accepted = accept_rule(*stats, params.eps_abs, params.eps_rel,
                               params.accept_abs, params.accept_rel)
        prim_s = prim / torch.clamp(torch.maximum(xmax, zmax), min=1e-12)
        dual_s = dual / torch.clamp(torch.maximum(pxmax, torch.maximum(qmax, ymax)), min=1e-12)
        ratio = torch.sqrt(prim_s / torch.clamp(dual_s, min=1e-16))
        rho = torch.where(accepted, rho,
                          torch.clamp(rho * ratio, 1e-8 * diag_scale, 1e8 * diag_scale))
    if d is not None:
        z, y = d * z, y / d
    return z, y, BoxQPAux(*stats, rho)
