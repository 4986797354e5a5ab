"""Condensed horizon QP (counterpart of mpc4quantum_tpu/solvers/condense.py),
batched over lanes.

The dynamics x_{t+1} = Delta_t + A_t x_t + B_t u_t, x_0 = x_init are
eliminated: x = w + M vec(U), vec(U) time-major. The tracking cost
sum_t Re[(x_t - xbm_t)^H Q_t (x_t - xbm_t)] + (u_t - ubm_t)^T R_t (u_t - ubm_t)
becomes U^T P U + 2 q^T U + const, and saturation plus the first-step slew
limit collapse into one box on U. `quad_program` solves it by the adaptive
Cholesky ADMM (backend "chol", the reference's default) or the fixed-budget
kernel route (backend "ns").
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels.boxqp import MAX_N, boxqp_accept, boxqp_big, boxqp_small
from ..utils.linalg import cx_mm
from ..utils.profiling import spans
from .boxqp import BoxQPParams, solve_boxqp
from .riccati import KINV_RICCATI, embed_costs, embed_ltv

QP_BACKENDS = ("chol", "ns")


class QPResult(NamedTuple):
    X: torch.Tensor          # (B, dim_x, H+1) complex optimal states (exact rollout)
    U: torch.Tensor          # (B, dim_u, H) real optimal controls
    obj: torch.Tensor        # (B,)
    converged: torch.Tensor  # (B,) bool
    # the final ADMM dual (B, H*dim_u, time-major) and penalty (B,) that
    # seed the next solve; None where the solver has none (the LQR)
    y: Optional[torch.Tensor] = None
    rho: Optional[torch.Tensor] = None
    iters: Optional[torch.Tensor] = None  # (B,) ADMM iterations (chol only)
    # the last round's K-inverse (B, n, n), the next solve's kinv0, and the
    # lanes whose carried inverse restarted from the cold init ((B,) bool);
    # on the boxqp_big route only
    kinv: Optional[torch.Tensor] = None
    guard_cold: Optional[torch.Tensor] = None


def condense_horizon(A_s, B_s, Delta_s, x_init):
    """Affine state map x = w + M vec(U).

    :param A_s: (B, H, dim_x, dim_x); :param B_s: (B, H, dim_x, dim_u);
    :param Delta_s: (B, H, dim_x); :param x_init: (B, dim_x).
    :return: w (B, H+1, dim_x), M (B, H+1, dim_x, H, dim_u); M[:, t, :, s, :]
        maps u_s to x_t.
    """
    Bn, H, dim_x, dim_u = B_s.shape
    w_t = x_init.to(A_s.dtype)
    M_t = torch.zeros((Bn, dim_x, H, dim_u), dtype=A_s.dtype, device=A_s.device)
    ws, Ms = [w_t], [M_t]
    for t in range(H):
        w_t = Delta_s[:, t] + (A_s[:, t] @ w_t[..., None])[..., 0]
        M_t = torch.einsum("bxy,byhd->bxhd", A_s[:, t], M_t)
        M_t[:, :, t, :] += B_s[:, t]
        ws.append(w_t)
        Ms.append(M_t)
    return torch.stack(ws, dim=1), torch.stack(Ms, dim=1)


def _assemble_cost(w, M, X_bm, U_bm, Q_s, R_s):
    """P (B, n, n) and q (B, n) of J(U) = U^T P U + 2 q^T U + c; the
    constant c does not enter the box QP and is not formed."""
    Bn, Hp1, dim_x, H, dim_u = M.shape
    n = H * dim_u
    Mf = M.reshape(Bn, Hp1, dim_x, n)
    e = w - X_bm.T                                   # (B, H+1, dim_x)
    QM = torch.einsum("txy,btyn->btxn", Q_s, Mf)
    Qe = torch.einsum("txy,bty->btx", Q_s, e)
    P = torch.einsum("btxn,btxm->bnm", Mf.conj(), QM).real
    q = torch.einsum("btxn,btx->bn", Mf.conj(), Qe).real
    # control cost: block-diagonal R over time, on time-major vec(U)
    Rr = R_s.real.to(P.dtype)
    ubm = U_bm.T.reshape(n).to(P.dtype)
    eyeH = torch.eye(H, dtype=P.dtype, device=P.device)
    Pu = torch.einsum("tij,ts->tisj", Rr, eyeH).reshape(n, n)
    return P + Pu, q - Pu @ ubm


def _box_bounds(dim_u, H, sat, u_prev, du, dtype, B, device):
    """Saturation |u_t| <= sat for every step (none where sat is None),
    intersected with the slew box |u_0 - u_prev| <= du on the first step
    where both are given. u_prev is (B, dim_u)."""
    sat = float("inf") if sat is None else float(sat)
    sat_v = torch.full((dim_u,), sat, dtype=dtype, device=device)
    lb = (-sat_v).repeat(H).expand(B, -1).clone()
    ub = sat_v.repeat(H).expand(B, -1).clone()
    if du is not None and u_prev is not None:
        u_prev = u_prev.to(dtype)
        lb[:, :dim_u] = torch.maximum(-sat_v, u_prev - du)
        ub[:, :dim_u] = torch.minimum(sat_v, u_prev + du)
    return lb, ub


def qp_data(x_init, X_bm, U_bm, Q_s, R_s, A_s, B_s, Delta_s, u_prev=None, sat=None,
            du=None):
    """Condense and assemble the batch's box QPs without solving them.

    :return: (P, q, lb, ub, w, M).
    """
    dim_u, H = U_bm.shape
    w, M = condense_horizon(A_s, B_s, Delta_s, x_init)
    P, q = _assemble_cost(w, M, X_bm, U_bm, Q_s, R_s)
    lb, ub = _box_bounds(dim_u, H, sat, u_prev, du, P.dtype, P.shape[0], P.device)
    return P, q, lb, ub, w, M


def qp_finish(w, M, Uvec, X_bm, U_bm, Q_s, R_s):
    """Exact rollout and objective of solved controls Uvec (B, H*dim_u).

    :return: X_opt (B, dim_x, H+1), U_opt (B, dim_u, H), obj (B,).
    """
    dim_u, H = U_bm.shape
    Bn, Hp1, dim_x = w.shape
    U_opt = Uvec.reshape(Bn, H, dim_u).transpose(1, 2)
    Mv = cx_mm(M.reshape(Bn, Hp1 * dim_x, H * dim_u), Uvec[..., None])[..., 0]
    X_opt = (w + Mv.reshape(Bn, Hp1, dim_x)).transpose(1, 2)
    return X_opt, U_opt, objective_value(X_opt, U_opt, X_bm, U_bm, Q_s, R_s)


def objective_value(X, U, X_bm, U_bm, Q_s, R_s):
    """Tracking objective of (X (B, dim_x, H+1), U (B, dim_u, H)): (B,)."""
    ex = (X - X_bm).transpose(1, 2)
    eu = (U - U_bm).transpose(1, 2)
    jx = torch.einsum("btx,txy,bty->b", ex.conj(), Q_s, ex).real
    ju = torch.einsum("bti,tij,btj->b", eu, R_s.real.to(eu.dtype), eu)
    return jx + ju


def quad_program(x_init, X_bm, U_bm, Q_s, R_s, A_s, B_s, Delta_s, u_prev=None, sat=None,
                 du=None, U_warm=None, params: BoxQPParams | None = None,
                 backend: str = "chol", Y_warm=None, rho_warm=None, kinv0=None,
                 kernel: str | None = None, data=None) -> QPResult:
    """Solve the lanes' LTV horizon tracking QPs (the reference's
    `quad_program`, batched).

    :param x_init: (B, dim_x) complex initial states, or (dim_x,) for one
        lane, with A_s (B, H, dim_x, dim_x), B_s, Delta_s, u_prev, U_warm,
        Y_warm and rho_warm then without the lane axis too.
    :param X_bm: (dim_x, H+1); U_bm: (dim_u, H); Q_s (H+1, dim_x, dim_x),
        R_s (H, dim_u, dim_u).
    :param u_prev: (B, dim_u) anchor of the first-step slew box |u_0 -
        u_prev| <= du; sat: the saturation (None = none).
    :param U_warm: optional (B, dim_u, H) ADMM warm start.
    :param backend: "chol", the adaptive Cholesky ADMM (`solve_boxqp`); or
        "ns", the fixed-budget route of the fleets: the `boxqp_small`
        kernel at n = H dim_u <= 16 (its Gauss-Jordan inverse whatever
        params.kinv says), `boxqp_big` above it with params.kinv's
        K-inverse; "riccati" / "riccati_pscan" factor the real embedding
        of these A_s, B_s, Q_s, R_s. On "chol" and at n <= 16 params.kinv,
        the Newton-Schulz budgets and `kinv0` are inert, as in the
        reference's kernel routes.
    :param Y_warm: optional (B, H*dim_u) time-major dual warm start;
        rho_warm: optional (B,) penalty warm start (<= 0 = cold).
    :param kinv0: optional (B, n, n) K-inverse carried from the previous
        solve (its QPResult.kinv), refreshed under params.ns_guard.
    :param kernel: on "ns", None = the size rule above; "small" or "big"
        forces that route (`boxqp_small` raises above n = 16 on the card).
    :param data: None, or (P, q, lb, ub, w, M) condensed already (as
        kernels/condense.condense_small gives them, in its own span
        qp.condense) in place of qp_data on A_s, B_s, Delta_s; these may
        then be None, unless a Riccati K-inverse on boxqp_big reads them.
    :return: QPResult with the exact rollout of the solved controls; `iters`
        on the chol backend only; `kinv` and `guard_cold` on boxqp_big.
    """
    if x_init.dim() == 1:
        one = lambda t: None if t is None or not torch.is_tensor(t) else t[None]
        res = quad_program(x_init[None], X_bm, U_bm, Q_s, R_s, one(A_s), one(B_s),
                           one(Delta_s), one(u_prev), sat, du, one(U_warm), params, backend,
                           one(Y_warm), None if rho_warm is None else torch.as_tensor(
                               rho_warm, dtype=x_init.real.dtype, device=x_init.device).reshape(1),
                           one(kinv0), kernel, None if data is None else tuple(map(one, data)))
        return QPResult(*(None if t is None else t[0] for t in res))
    params = BoxQPParams() if params is None else params
    if backend not in QP_BACKENDS:
        raise ValueError(f"backend={backend!r} is not one of {QP_BACKENDS}")
    if data is None:
        with spans.span("qp.condense", events=True, route="plain"):
            data = qp_data(x_init, X_bm, U_bm, Q_s, R_s, A_s, B_s, Delta_s, u_prev, sat, du)
    P, q, lb, ub, w, M = data
    x0 = None if U_warm is None else U_warm.transpose(1, 2).reshape(P.shape[0], -1).to(P.dtype)
    iters = kinv = guard_cold = None
    if backend == "chol":
        res = solve_boxqp(P, q, lb, ub, x0=x0, params=params, y0=Y_warm, rho0=rho_warm)
        z, y, rho, converged, iters = res.x, res.y, res.rho, res.converged, res.iters
    else:
        kw = dict(iters=params.max_iter, rounds=params.n_rounds, rho_scale=params.rho0,
                  sigma=params.sigma, alpha=params.alpha, eps_abs=params.eps_abs,
                  eps_rel=params.eps_rel, acc_abs=params.accept_abs,
                  acc_rel=params.accept_rel, scale=params.scale)
        if (kernel or ("small" if P.shape[-1] <= MAX_N else "big")) == "small":
            z, y, aux = boxqp_small(P, q, lb, ub, x0=x0, y0=Y_warm, rho0=rho_warm, **kw)
        else:
            lqr_data = None
            if params.kinv in KINV_RICCATI:
                # the same LTV data that built P, real-embedded
                Ar, Br = embed_ltv(A_s, B_s)
                Qr, Rr = embed_costs(Q_s, R_s)
                lqr_data = tuple(t.to(P.dtype) for t in (Ar, Br, Qr, Rr))
            z, y, aux, kinv, guard_cold = boxqp_big(
                P, q, lb, ub, x0=x0, y0=Y_warm, rho0=rho_warm, kinv_method=params.kinv,
                ns_iters=params.ns_iters, ns_refresh=params.ns_refresh,
                ns_guard=params.ns_guard, ns_polish=params.ns_polish, kinv0=kinv0,
                lqr_data=lqr_data, **kw)
        rho = aux.rho
        converged = boxqp_accept(aux, params.eps_abs, params.eps_rel, params.accept_abs,
                                 params.accept_rel)
    X_opt, U_opt, obj = qp_finish(w, M, z.to(P.dtype), X_bm, U_bm, Q_s, R_s)
    return QPResult(X=X_opt, U=U_opt, obj=obj, converged=converged, y=y, rho=rho, iters=iters,
                    kinv=kinv, guard_cold=guard_cold)
