"""Fixed-budget ADMM for batches of box QPs (counterpart of the
`kinv="gj"` path of mpc4quantum_tpu/solvers/boxqp.py `solve_boxqp_fixed`).

Solves, per lane b,  min 1/2 x^T P_b x + q_b^T x  s.t.  lb_b <= x <= ub_b
with `n_rounds` rounds of exactly `max_iter` relaxed OSQP-style iterations:

    x~ = (P + (sigma+rho) I)^{-1} (sigma x - q + rho z - y)
    z  = clip(alpha x~ + (1-alpha) z + y/rho, lb, ub)
    y  = y + rho (alpha x~ + (1-alpha) z_old - z)

with the inverse taken by unpivoted Gauss-Jordan each round, and rho
rebalanced between rounds by the OSQP residual rule, frozen once the round
passes the acceptance test. This is the plain version of the box-QP kernel
(kernels/boxqp.py): the same algorithm in the same order.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..utils.linalg import gj_inverse


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


class BoxQPAux(NamedTuple):
    """Per-lane (B,) residual statistics of a solve, in the kernel's aux row
    order: final primal/dual residuals, the inf-norm scalings, and the final
    (post-rebalance) rho - the warm value for the next solve."""

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


def _clip(v, lb, ub):
    return torch.minimum(torch.maximum(v, lb), ub)


def _maxabs(v):
    return v.abs().amax(dim=-1)


def solve_boxqp_fixed(P, q, lb, ub, x0=None, y0=None, rho0=None,
                      params: BoxQPParams | None = None):
    """Batched fixed-budget ADMM.

    :param P: (B, n, n) PSD (symmetrized here); q, lb, ub: (B, n).
    :param x0: optional (B, n) warm start, clipped into the box.
    :param y0: optional (B, n) dual warm start (None = zeros).
    :param rho0: optional (B,) penalty warm start; lanes <= 0 take the cold
        default rho0 * mean(diag P).
    :return: (z (B, n) box-feasible solution, y (B, n) dual, BoxQPAux).
    """
    params = BoxQPParams() if params is None else params
    B, n = q.shape
    P = 0.5 * (P + P.transpose(-1, -2))
    eye = torch.eye(n, dtype=P.dtype, device=P.device)
    diag_scale = torch.clamp(torch.diagonal(P, dim1=-2, dim2=-1).mean(dim=-1), min=1e-12)
    rho = warm_rho(rho0, params.rho0 * diag_scale, diag_scale)
    x = _clip(torch.zeros_like(q) if x0 is None else x0, lb, ub)
    z = x
    y = torch.zeros_like(q) if y0 is None else y0
    qmax = _maxabs(q)
    sigma, alpha = params.sigma, params.alpha
    for _ in range(params.n_rounds):
        Kinv = gj_inverse(P + (sigma + rho)[:, None, None] * eye)
        r = rho[:, None]
        for _ in range(params.max_iter):
            x = (Kinv @ (sigma * x - q + r * z - y)[..., None])[..., 0]
            z_arg = alpha * x + (1 - alpha) * z
            z_new = _clip(z_arg + y / r, lb, ub)
            y = y + r * (z_arg - z_new)
            z = z_new
        Px = (P @ x[..., None])[..., 0]
        stats = (_maxabs(x - z), _maxabs(Px + q + y), _maxabs(x), _maxabs(z),
                 _maxabs(Px), qmax, _maxabs(y))
        prim, dual, xmax, zmax, pxmax, _, ymax = stats
        accepted = accept_rule(*stats, params.eps_abs, params.eps_rel,
                               params.accept_abs, params.accept_rel)
        prim_s = prim / torch.clamp(torch.maximum(xmax, zmax), min=1e-12)
        dual_s = dual / torch.clamp(torch.maximum(pxmax, torch.maximum(qmax, ymax)), min=1e-12)
        ratio = torch.sqrt(prim_s / torch.clamp(dual_s, min=1e-16))
        rho = torch.where(accepted, rho,
                          torch.clamp(rho * ratio, 1e-8 * diag_scale, 1e8 * diag_scale))
    return z, y, BoxQPAux(*stats, rho)
