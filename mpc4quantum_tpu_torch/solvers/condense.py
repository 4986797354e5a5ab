"""Condensed horizon QP (counterpart of mpc4quantum_tpu/solvers/condense.py),
batched over lanes.

The dynamics x_{t+1} = Delta_t + A_t x_t + B_t u_t, x_0 = x_init are
eliminated: x = w + M vec(U), vec(U) time-major. The tracking cost
sum_t Re[(x_t - xbm_t)^H Q_t (x_t - xbm_t)] + (u_t - ubm_t)^T R_t (u_t - ubm_t)
becomes U^T P U + 2 q^T U + const, and saturation plus the first-step slew
limit collapse into one box on U.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.linalg import cx_mm


class QPResult(NamedTuple):
    X: torch.Tensor          # (B, dim_x, H+1) complex optimal states (exact rollout)
    U: torch.Tensor          # (B, dim_u, H) real optimal controls
    obj: torch.Tensor        # (B,)
    converged: torch.Tensor  # (B,) bool
    y: torch.Tensor          # (B, H*dim_u) final ADMM dual, time-major
    rho: torch.Tensor        # (B,) final ADMM penalty


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


def _box_bounds(dim_u, H, sat, u_prev, du, dtype):
    """Saturation |u_t| <= sat for every step, intersected with the slew
    box |u_0 - u_prev| <= du on the first step. u_prev is (B, dim_u)."""
    sat_v = torch.full((dim_u,), float(sat), dtype=dtype, device=u_prev.device)
    lb = (-sat_v).repeat(H).expand(u_prev.shape[0], -1).clone()
    ub = sat_v.repeat(H).expand(u_prev.shape[0], -1).clone()
    if du is not None:
        u_prev = u_prev.to(dtype)
        lb[:, :dim_u] = torch.maximum(-sat_v, u_prev - du)
        ub[:, :dim_u] = torch.minimum(sat_v, u_prev + du)
    return lb, ub


def qp_data(x_init, X_bm, U_bm, Q_s, R_s, A_s, B_s, Delta_s, u_prev, sat, du=None):
    """Condense and assemble the batch's box QPs without solving them.

    :return: (P, q, lb, ub, w, M).
    """
    dim_u, H = U_bm.shape
    w, M = condense_horizon(A_s, B_s, Delta_s, x_init)
    P, q = _assemble_cost(w, M, X_bm, U_bm, Q_s, R_s)
    lb, ub = _box_bounds(dim_u, H, sat, u_prev, du, P.dtype)
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
