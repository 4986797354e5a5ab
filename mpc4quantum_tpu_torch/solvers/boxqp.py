"""Box-QP solvers for batches of lanes (counterpart of
mpc4quantum_tpu/solvers/boxqp.py): the fixed-budget `solve_boxqp_fixed`,
with the K-inverse of each round by Gauss-Jordan, by Newton-Schulz (cold,
or warm-started from a carried inverse under a contraction guard) or by
the Riccati factorization of the un-condensed problem, and the Jacobi-scaled
form; and the adaptive Cholesky ADMM `solve_boxqp` (below).

The fixed-budget solver solves, per lane b,
min 1/2 x^T P_b x + q_b^T x  s.t.  lb_b <= x <= ub_b, with `n_rounds`
rounds of exactly `max_iter` relaxed OSQP-style iterations:

    x~ = (P + (sigma+rho) I)^{-1} (sigma x - q + rho z - y)
    z  = clip(alpha x~ + (1-alpha) z + y/rho, lb, ub)
    y  = y + rho (alpha x~ + (1-alpha) z_old - z)

with rho rebalanced between rounds by the OSQP residual rule, frozen once
the round passes the acceptance test. With `scale` the QP is solved in
Jacobi-equilibrated coordinates and the residuals are reported in the
original ones. This is the plain version of both box-QP kernels
(kernels/boxqp.py): the same algorithm in the same order.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from ..utils.linalg import gj_inverse
from ..utils.profiling import host_flag, spans
from .riccati import KINV_RICCATI, riccati_kinv_batch

KINV_METHODS = ("gj", "ns") + KINV_RICCATI


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
    # Newton-Schulz iterations of the cold "ns" K-inverse
    ns_iters: int = 30
    # Newton-Schulz iterations of a warm-started inverse: the refresh from
    # a carried inverse (kinv0) and from the previous round's rescaled one
    ns_refresh: int = 10
    # the carried inverse X0 is kept where ||I - K X0||_inf < ns_guard, else
    # that lane restarts from the cold init (at the refresh budget it will
    # not converge; the acceptance test flags the solve)
    ns_guard: float = 0.9
    # K-inverse of each round: "gj" Gauss-Jordan, "ns" Newton-Schulz,
    # "riccati" / "riccati_pscan" the Riccati factorization of the LTV
    # problem that built P (solvers/riccati.py; needs lqr_data) on round 1,
    # refreshed by Newton-Schulz on later rounds
    kinv: str = "ns"
    # Newton-Schulz polish steps on the Riccati inverse
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
    order (boxqp_small's output buffer has exactly these rows): final
    primal/dual residuals, the inf-norm scalings, and the final
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


class FixedSolve(NamedTuple):
    """What a fixed-budget solve returns: the box-feasible solution z and
    the dual y (B, n), unscaled; the residual statistics; the last round's
    K-inverse (B, n, n) in the solve's own (with `scale`, Jacobi-scaled)
    coordinates, the next solve's `kinv0`; and the lanes whose carried
    inverse failed the contraction guard and restarted from the cold init
    ((B,) bool; None when no inverse was carried in)."""

    z: torch.Tensor
    y: torch.Tensor
    aux: BoxQPAux
    kinv: torch.Tensor
    guard_cold: Optional[torch.Tensor] = None


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


def _ns_inverse(K, iters: int, X0=None, guard: float = 0.5):
    """`ns_inverse`, with the (...,) bool mask of the elements that kept X0
    (None without X0)."""
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    n1 = K.abs().sum(dim=-2).amax(dim=-1)
    ninf = K.abs().sum(dim=-1).amax(dim=-1)
    # written contiguous, the layout torch.where gives a lane the guard
    # sends cold, so that lane's K @ X rounds as the cold chain's does
    X = torch.div(K.transpose(-1, -2), (n1 * ninf)[..., None, None],
                  out=torch.empty_like(K, memory_format=torch.contiguous_format))
    kept = None
    if X0 is not None:
        # induced inf-norm of the residual: the largest row sum of |I - K X0|
        r0 = (eye - K @ X0).abs().sum(dim=-1).amax(dim=-1)
        kept = r0 < guard
        X = torch.where(kept[..., None, None], X0.to(K.dtype), X)
    for i in range(iters):
        if i == iters - 1 and K.dtype == torch.float32:
            # the same step, X + X (I - K X), its residual formed in float64
            R = eye.double() - K.double() @ X.double()
            X = X + X @ R.to(K.dtype)
        else:
            X = X @ (2.0 * eye - K @ X)
    return X, kept


def ns_inverse(K, iters: int = 30, X0=None, guard: float = 0.5):
    """Inverse of a batch of SPD matrices (..., n, n) by the Newton-Schulz
    iteration X <- X (2I - K X), matmuls only. The cold init
    X = K^T / (||K||_1 ||K||_inf) contracts for SPD K.

    In float32 the last step is taken as X + X (I - K X) with I - K X formed
    in float64: the same step in exact arithmetic, but float32's own
    iteration stalls where the rounding of K X is as large as the residual
    (about n eps cond(K)), and ADMM's fixed point inherits the error as a
    dual residual of about ||I - K X|| |P x|. At cnot_state's horizon 250
    (n 750) that stall, ~1e-5, failed the acceptance test; the float64
    residual brings X to float32's rounding of K^-1 (~2e-7 there).

    :param X0: optional warm start, the inverse of a nearby matrix (the
        previous solve's). Each element keeps X0 where ||I - K X0||_inf <
        guard and takes the cold init otherwise; from a kept X0 the
        iteration converges quadratically from a residual below the guard.
        A cold fallback at a refresh-sized `iters` does not converge: the
        caller's acceptance test is the safety net.
    """
    return _ns_inverse(K, iters, X0, guard)[0]


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
                      admm: Optional[Callable] = None,
                      ns_cold: Optional[Callable] = None) -> FixedSolve:
    """Batched fixed-budget ADMM.

    Each round's K-inverse, by params.kinv: "gj" the exact Gauss-Jordan
    inverse; "riccati" / "riccati_pscan" the exact inverse of the Riccati
    factorization of `lqr_data` on round 1 (plus params.ns_polish
    Newton-Schulz steps), refreshed on later rounds by params.ns_refresh
    steps from the previous inverse rescaled by (sigma + rho_old) /
    (sigma + rho_new), which contracts since K changed by a multiple of I;
    "ns" the cold Newton-Schulz chain of params.ns_iters steps, or with
    `kinv0` params.ns_refresh steps from kinv0 on round 1 (lanes where it
    fails the params.ns_guard contraction guard restart from the cold init)
    and from the rescaled previous inverse on later rounds. The exact
    inverses make kinv0 moot.

    :param P: (B, n, n) PSD (symmetrized here); q, lb, ub: (B, n).
    :param x0: optional (B, n) warm start, clipped into the box.
    :param y0: optional (B, n) dual warm start (None = zeros), unscaled.
    :param rho0: optional (B,) penalty warm start in the solver's space;
        lanes <= 0 take the cold default rho0 * mean(diag P).
    :param kinv0: optional (B, n, n) inverse carried from the previous
        solve of a chain (its FixedSolve.kinv, in its scaled coordinates).
    :param lqr_data: (Ar (B, H, m, m), Br (B, H, m, du), Qr (H+1, m, m),
        Rr (H, du, du)), the real-embedded LTV problem whose condensed
        Hessian is P (solvers/riccati.embed_ltv / embed_costs); needed by
        the Riccati inverses.
    :param admm: the ADMM inner loop, with the signature of `admm_iters`
        (the default); kernels/boxqp.boxqp_big passes the CUDA kernel.
    :param ns_cold: the cold "ns" chain `(K, iters) -> K^-1`, taken where
        `ns_cold.fits(K)` (else `ns_inverse`); kernels/boxqp.boxqp_big passes
        the CUDA kernel (kernels/nsinv.ns_cold). The span qp.kinv names the
        route taken: "kernel" there, "plain" for every other K^-1.
    :return: FixedSolve (z, y, aux, kinv, guard_cold).
    """
    params = BoxQPParams() if params is None else params
    if params.kinv not in KINV_METHODS:
        raise ValueError(f"kinv={params.kinv!r} is not one of {KINV_METHODS}")
    use_riccati = params.kinv in KINV_RICCATI
    if use_riccati and lqr_data is None:
        raise ValueError(f"kinv={params.kinv!r} needs the LTV problem (lqr_data) that built P")
    if use_riccati or params.kinv == "gj":
        kinv0 = None  # exact inverses: the carried one is moot
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
    Kinv = rho_prev = guard_cold = None
    for rnd in range(params.n_rounds):
        K = P + (sigma + rho)[:, None, None] * eye
        cold = params.kinv == "ns" and kinv0 is None
        route = "kernel" if cold and ns_cold is not None and ns_cold.fits(K) else "plain"
        with spans.span("qp.kinv", events=True, route=route):
            if params.kinv == "gj":
                Kinv = gj_inverse(K)
            elif use_riccati and rnd == 0:
                Ar, Br, Qr, Rr = (t.to(P.dtype) for t in lqr_data)
                Kinv = riccati_kinv_batch(Ar, Br, Qr, Rr, rho, sigma, d=d,
                                          pscan=params.kinv == "riccati_pscan")
                for _ in range(params.ns_polish):
                    Kinv = Kinv @ (2.0 * eye - K @ Kinv)
            elif rnd > 0 and (use_riccati or kinv0 is not None):
                # K moved by (rho - rho_prev) I: the rescaled previous inverse
                # contracts wherever it had converged (no guard can tell a large
                # rho jump from a partial inverse; acceptance flags the rest)
                c = torch.clamp((sigma + rho_prev) / (sigma + rho), max=1.0)
                Kinv = ns_inverse(K, params.ns_refresh, X0=c[:, None, None] * Kinv,
                                  guard=float("inf"))
            elif kinv0 is not None:
                Kinv, kept = _ns_inverse(K, params.ns_refresh, X0=kinv0, guard=params.ns_guard)
                guard_cold = ~kept
            elif route == "kernel":
                Kinv = ns_cold(K, params.ns_iters)
            else:
                Kinv = ns_inverse(K, params.ns_iters)
        rho_prev = rho
        x, z, y = admm(Kinv, q, lb, ub, rho, x, z, y, iters=params.max_iter, sigma=sigma,
                       alpha=params.alpha)
        stats = _residual_stats(P, q, x, z, y, d)
        accepted = accept_rule(*stats, params.eps_abs, params.eps_rel,
                               params.accept_abs, params.accept_rel)
        rho = _rebalance(rho, stats, accepted, diag_scale)
    if d is not None:
        z, y = d * z, y / d
    return FixedSolve(z, y, BoxQPAux(*stats, rho), Kinv, guard_cold)


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
