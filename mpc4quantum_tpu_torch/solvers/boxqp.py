"""Box-QP solvers for batches of lanes (counterpart of
mpc4quantum_tpu/solvers/boxqp.py): the fixed-budget `solve_boxqp_fixed`, with
the `kinv="gj"` and cold `kinv="ns"` inverses and the Jacobi-scaled form,
and the adaptive Cholesky ADMM `solve_boxqp` (below).

The fixed-budget solver solves, per lane b,
min 1/2 x^T P_b x + q_b^T x  s.t.  lb_b <= x <= ub_b, with `n_rounds`
rounds of exactly `max_iter` relaxed OSQP-style iterations:

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
from ..utils.profiling import host_flag

KINV_METHODS = ("gj", "ns")


@dataclasses.dataclass(frozen=True)
class BoxQPParams:
    """The reference's BoxQPParams, field for field but its loop-form flag
    `unroll` (the port has one loop form)."""

    rho0: float = 0.1
    sigma: float = 1e-6
    alpha: float = 1.6
    eps_abs: float = 1e-6
    eps_rel: float = 1e-6
    max_iter: int = 150
    n_rounds: int = 2
    # solve_boxqp tests the eps targets every check_every iterations of a round
    check_every: int = 5
    # acceptance thresholds: a solve is declared failed only beyond these
    accept_abs: float = 1e-3
    accept_rel: float = 1e-3
    # Newton-Schulz iterations of the "ns" K-inverse
    ns_iters: int = 30
    # the carried-inverse refresh (kinv0) and its contraction guard; not
    # ported: `check_ported` refuses values other than these
    ns_refresh: int = 10
    ns_guard: float = 0.9
    # K-inverse of each round: "gj" Gauss-Jordan, "ns" cold Newton-Schulz;
    # the reference's "riccati" and "riccati_pscan" are not ported
    kinv: str = "ns"
    # Newton-Schulz polish of the Riccati inverse; not ported with it
    ns_polish: int = 1
    # Jacobi equilibration: solve in x' = x / d, d = diag(P)^-1/2
    scale: bool = False


class BoxQPResult(NamedTuple):
    """Per-lane result of `solve_boxqp`, each with the leading lane axis B."""

    x: torch.Tensor          # (B, n) the projected iterate z: box-feasible
    y: torch.Tensor          # (B, n) dual of the box constraint
    iters: torch.Tensor      # (B,) int32 ADMM iterations over all rounds
    prim_res: torch.Tensor   # (B,)
    dual_res: torch.Tensor   # (B,)
    converged: torch.Tensor  # (B,) bool: the acceptance test
    rho: torch.Tensor        # (B,) final penalty, in the solver's space


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


# fields that tune only the K-inverse carry and the Riccati inverse
UNPORTED_FIELDS = ("ns_refresh", "ns_guard", "ns_polish")


def check_ported(params: BoxQPParams):
    """Raise NotImplementedError where `params` asks for what the port does
    not have: kinv "riccati" / "riccati_pscan", or a K-inverse carry or
    Riccati option (ns_refresh, ns_guard, ns_polish) away from its default."""
    if params.kinv in ("riccati", "riccati_pscan"):
        raise NotImplementedError(f"kinv={params.kinv!r} (the Riccati K-inverse) is not ported "
                                  "yet; see ROADMAP.md")
    changed = [f for f in UNPORTED_FIELDS if getattr(params, f) != getattr(BoxQPParams, f)]
    if changed:
        raise NotImplementedError(f"{', '.join(changed)} tune the K-inverse carry and the "
                                  "Riccati inverse, which are not ported yet; see ROADMAP.md")


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


def _residual_stats(P, q, x, z, y, d=None):
    """Per-lane (B,) residual statistics in the kernels' aux row order
    (prim, dual, xmax, zmax, pxmax, qmax, ymax), in the original
    coordinates: with the Jacobi scale d, primal rows are weighted by d and
    dual rows by 1/d."""
    wp = (lambda v: v) if d is None else (lambda v: d * v)
    wd = (lambda v: v) if d is None else (lambda v: v / d)
    Px = (P @ x[..., None])[..., 0]
    return (_maxabs(wp(x - z)), _maxabs(wd(Px + q + y)), _maxabs(wp(x)), _maxabs(wp(z)),
            _maxabs(wd(Px)), _maxabs(wd(q)), _maxabs(wd(y)))


def _rebalance(rho, stats, keep, diag_scale):
    """The OSQP rho rule: rho sqrt(relative prim / relative dual), clipped
    to the adaptation range, on the lanes not in `keep`."""
    prim, dual, xmax, zmax, pxmax, qmax, ymax = stats
    prim_s = prim / torch.clamp(torch.maximum(xmax, zmax), min=1e-12)
    dual_s = dual / torch.clamp(torch.maximum(pxmax, torch.maximum(qmax, ymax)), min=1e-12)
    ratio = torch.sqrt(prim_s / torch.clamp(dual_s, min=1e-16))
    return torch.where(keep, rho, torch.clamp(rho * ratio, 1e-8 * diag_scale, 1e8 * diag_scale))


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
    check_ported(params)
    if params.kinv not in KINV_METHODS:
        raise NotImplementedError(f"kinv={params.kinv!r} is not ported; use one of {KINV_METHODS}")
    admm = admm_iters if admm is None else admm
    B, n = q.shape
    P = 0.5 * (P + P.transpose(-1, -2))
    d = None
    if params.scale:
        P, q, lb, ub, x0, y0, d = jacobi_scale_boxqp(P, q, lb, ub, x0, y0)
    eye = torch.eye(n, dtype=P.dtype, device=P.device)
    diag_scale = torch.clamp(torch.diagonal(P, dim1=-2, dim2=-1).mean(dim=-1), min=1e-12)
    rho = warm_rho(rho0, params.rho0 * diag_scale, diag_scale)
    x = _clip(torch.zeros_like(q) if x0 is None else x0, lb, ub)
    z = x
    y = torch.zeros_like(q) if y0 is None else y0
    sigma = params.sigma
    for _ in range(params.n_rounds):
        K = P + (sigma + rho)[:, None, None] * eye
        Kinv = gj_inverse(K) if params.kinv == "gj" else ns_inverse(K, params.ns_iters)
        x, z, y = admm(Kinv, q, lb, ub, rho, x, z, y, iters=params.max_iter, sigma=sigma,
                       alpha=params.alpha)
        stats = _residual_stats(P, q, x, z, y, d)
        accepted = accept_rule(*stats, params.eps_abs, params.eps_rel,
                               params.accept_abs, params.accept_rel)
        rho = _rebalance(rho, stats, accepted, diag_scale)
    if d is not None:
        z, y = d * z, y / d
    return z, y, BoxQPAux(*stats, rho)


def solve_boxqp(P, q, lb, ub, x0=None, params: BoxQPParams | None = None, y0=None,
                rho0=None) -> BoxQPResult:
    """The adaptive ADMM of the reference's `solve_boxqp` over a lane batch,
    with the semantics of `jax.vmap` over its loops.

    Each of `n_rounds` rounds factors K = P + (sigma + rho) I by Cholesky and
    runs up to `max_iter` relaxed ADMM steps through the factor; a lane
    tests its eps targets at every `check_every`-th step of a round and,
    once they hold, is frozen at that iterate (its iteration count stops).
    After a round the targets are tested on the round's last iterate; a
    lane that meets them keeps its rho and runs no later round, the others
    take the OSQP rho rebalance. The batch's round ends when every lane is
    done: the host reads that flag once every `check_every` steps
    (`utils.profiling.host_flag`), and once after each round, and a round
    in which every lane has converged is not run. A matrix that Cholesky
    cannot factor gives NaN, as in the reference: that lane never
    converges and nothing raises.

    :param P: (B, n, n) PSD (symmetrized here); q, lb, ub: (B, n).
    :param x0: optional (B, n) warm start, clipped into the box.
    :param y0: optional (B, n) dual warm start (None = zeros).
    :param rho0: optional (B,) penalty warm start; lanes <= 0 take the cold
        default params.rho0 * mean(diag P).
    :return: BoxQPResult; x is the projected iterate z, so box-feasible,
        and `converged` is the acceptance test (the eps targets loosened to
        accept_abs / accept_rel).
    """
    params = BoxQPParams() if params is None else params
    check_ported(params)
    B, n = q.shape
    P = 0.5 * (P + P.transpose(-1, -2))
    d = None
    if params.scale:
        P, q, lb, ub, x0, y0, d = jacobi_scale_boxqp(P, q, lb, ub, x0, y0)
    sigma, alpha = params.sigma, params.alpha
    eye = torch.eye(n, dtype=P.dtype, device=P.device)
    diag_scale = torch.clamp(torch.diagonal(P, dim1=-2, dim2=-1).mean(dim=-1), min=1e-12)
    rho = warm_rho(rho0, params.rho0 * diag_scale, diag_scale)
    x = _clip(torch.zeros_like(q) if x0 is None else x0, lb, ub)
    z = x
    y = torch.zeros_like(q) if y0 is None else y0
    iters = torch.zeros(B, dtype=torch.int32, device=q.device)
    converged = torch.zeros(B, dtype=torch.bool, device=q.device)

    def targets_met(stats):
        eps = (params.eps_abs, params.eps_rel)
        return accept_rule(*stats, *eps, *eps)

    for rnd in range(params.n_rounds):
        if rnd and host_flag(converged.all()):
            break
        L, info = torch.linalg.cholesky_ex(P + (sigma + rho)[:, None, None] * eye)
        L = torch.where((info == 0)[:, None, None], L, float("nan"))
        r = rho[:, None]
        done = converged
        it = 0
        while it < params.max_iter:
            # done changes only at a check, so a lane done before this chunk
            # of steps is restored after it: frozen at its own exit iterate
            steps = min(params.check_every - it % params.check_every, params.max_iter - it)
            held = (x, z, y)
            for _ in range(steps):
                rhs = sigma * x - q + r * z - y
                x_t = torch.cholesky_solve(rhs[..., None], L)[..., 0]
                z_arg = alpha * x_t + (1 - alpha) * z
                z_new = _clip(z_arg + y / r, lb, ub)
                y = y + r * (z_arg - z_new)
                x, z = x_t, z_new
            live = ~done
            x, z, y = (torch.where(live[:, None], a, b) for a, b in zip((x, z, y), held))
            iters = iters + steps * live.to(torch.int32)
            it += steps
            if it % params.check_every == 0:
                done = done | targets_met(_residual_stats(P, q, x, z, y, d))
                if it < params.max_iter and host_flag(done.all()):
                    break
        stats = _residual_stats(P, q, x, z, y, d)
        converged = targets_met(stats)
        rho = _rebalance(rho, stats, converged, diag_scale)
    stats = _residual_stats(P, q, x, z, y, d)
    accepted = accept_rule(*stats, params.eps_abs, params.eps_rel, params.accept_abs,
                           params.accept_rel)
    if d is not None:
        z, y = d * z, y / d
    return BoxQPResult(x=z, y=y, iters=iters, prim_res=stats[0], dual_res=stats[1],
                       converged=accepted, rho=rho)
