"""Solver-free affine-tracking LQR over the horizon (counterpart of
mpc4quantum_tpu/solvers/lqr.py), batched over lanes.

A backward value iteration over the affine-augmented dynamics [x; 1], with
the benchmark tracked and the linearization offset Delta_s folded into the
affine row, gives one gain a step; a forward rollout applies the gains and
clips each control to the saturation box. No first-step slew box, no
iterative solver and no duals.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.linalg import cx_solve


class LQRResult(NamedTuple):
    X: torch.Tensor          # (B, dim_x, H+1) complex rollout
    U: torch.Tensor          # (B, dim_u, H) real clipped controls
    cost: torch.Tensor       # (B,)
    gains: torch.Tensor      # (B, H, dim_u, dim_x+1) complex


def _dag(A: torch.Tensor) -> torch.Tensor:
    return A.conj().transpose(-1, -2)


def _q_aug(Q: torch.Tensor, xbm: torch.Tensor) -> torch.Tensor:
    """[[Q, -Q xbm], [-(Q xbm)^H, Re(xbm^H Q xbm)]] for Q (dim_x, dim_x)
    shared and xbm (B, dim_x): (B, dim_x+1, dim_x+1)."""
    qx = (Q @ xbm[..., None])[..., 0]
    corner = (xbm.conj() * qx).sum(dim=-1).real.to(Q.dtype)
    top = torch.cat([Q.expand(xbm.shape[0], -1, -1), -qx[..., None]], dim=-1)
    bot = torch.cat([-qx.conj()[:, None, :], corner[:, None, None]], dim=-1)
    return torch.cat([top, bot], dim=-2)


def lqr_quad_program(x0, X_bm, U_bm, Q_s, R_s, A_s, B_s, sat=None,
                     Delta_s: Optional[torch.Tensor] = None) -> LQRResult:
    """Affine-tracking LQR of the reference, per lane.

    :param x0: (B, dim_x) complex initial states, or (dim_x,) for one lane.
    :param X_bm: (dim_x, H+1) benchmarks; U_bm: (dim_u, H).
    :param Q_s: (H+1, dim_x, dim_x); R_s: (H, dim_u, dim_u).
    :param A_s, B_s: (B, H, dim_x, dim_x), (B, H, dim_x, dim_u) (no lane
        axis with a (dim_x,) x0).
    :param sat: optional saturation of the forward rollout's controls.
    :param Delta_s: optional (B, H, dim_x) affine residuals of the dynamics.
    :return: LQRResult (without the lane axis for a (dim_x,) x0).

    The gain system R + B^H V B takes a Tikhonov jitter of 1e-12 trace and a
    direct solve through the real embedding (utils.linalg.cx_solve), as in
    the reference; a singular one gives NaN gains, and the caller reads a
    non-finite rollout as a failure.
    """
    if x0.dim() == 1:
        one = lambda t: None if t is None else t[None]
        res = lqr_quad_program(x0[None], X_bm, U_bm, Q_s, R_s, A_s[None], B_s[None], sat,
                               one(Delta_s))
        return LQRResult(*(t[0] for t in res))
    Bn, H, dim_x, dim_u = B_s.shape
    cdtype = A_s.dtype
    rdtype = x0.real.dtype
    dev = A_s.device
    X_bm = X_bm.to(cdtype)
    R_c = R_s.to(cdtype)
    eye = torch.eye(dim_x, dtype=cdtype, device=dev)
    deltas = (torch.zeros((Bn, H, dim_x), dtype=cdtype, device=dev) if Delta_s is None
              else Delta_s.to(cdtype))
    ubm = U_bm.to(rdtype)
    V = _q_aug(Q_s[-1].to(cdtype), X_bm[:, -1].expand(Bn, -1))
    zero_row = torch.zeros((Bn, 1, dim_x), dtype=cdtype, device=dev)
    one = torch.ones((Bn, 1, 1), dtype=cdtype, device=dev)
    B_a_pad = torch.zeros((Bn, 1, dim_u), dtype=cdtype, device=dev)
    gains = [None] * H
    for t in reversed(range(H)):
        A, Bt = A_s[:, t], B_s[:, t]
        xbm = X_bm[:, t].expand(Bn, -1)
        aff = (((A - eye) @ xbm[..., None])[..., 0]
               + (Bt @ ubm[:, t].to(cdtype)[:, None])[..., 0] + deltas[:, t])
        A_a = torch.cat([torch.cat([A, aff[..., None]], dim=-1),
                         torch.cat([zero_row, one], dim=-1)], dim=-2)
        B_a = torch.cat([Bt, B_a_pad], dim=-2)
        Q_a = _q_aug(Q_s[t].to(cdtype), xbm)
        BtV = _dag(B_a) @ V
        M = R_c[t] + BtV @ B_a
        tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(dim=-1).real.to(cdtype)
        M = M + 1e-12 * tr[:, None, None] * torch.eye(dim_u, dtype=cdtype, device=dev)
        K = -cx_solve(M, BtV @ A_a)
        S = A_a + B_a @ K
        V = Q_a + _dag(K) @ R_c[t] @ K + _dag(S) @ V @ S
        gains[t] = K
    gains = torch.stack(gains, dim=1)
    x = x0.to(cdtype)
    cost = torch.zeros(Bn, dtype=rdtype, device=dev)
    R_r = R_s.real.to(rdtype)
    xs, us = [x], []
    ones = torch.ones((Bn, 1), dtype=cdtype, device=dev)
    for t in range(H):
        dx_aug = torch.cat([x - X_bm[:, t], ones], dim=-1)
        u = (gains[:, t] @ dx_aug[..., None])[..., 0].real + ubm[:, t]
        if sat is not None:
            u = torch.clamp(u, -sat, sat)
        x = (A_s[:, t] @ x[..., None])[..., 0] + (B_s[:, t] @ u.to(cdtype)[..., None])[..., 0] \
            + deltas[:, t]
        Qn = Q_s[t + 1].to(cdtype)
        cost = cost + (x.conj() * (x @ Qn.T)).sum(dim=-1).real + ((u @ R_r[t].T) * u).sum(dim=-1)
        xs.append(x)
        us.append(u)
    return LQRResult(X=torch.stack(xs, dim=-1), U=torch.stack(us, dim=-1), cost=cost,
                     gains=gains)
