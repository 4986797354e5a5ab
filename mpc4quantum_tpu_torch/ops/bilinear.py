"""Trajectory-local linearization of discrete bilinear models (counterpart
of mpc4quantum_tpu/ops/bilinear.py), batched over lanes.

The model is `x+ = A x + N (f(u) (kr) x)`; along a guess trajectory it
gives the per-step affine models `x_{t+1} = Delta_t + A_t x_t + B_t u_t`
that the condensed QP consumes. `bilinear_f`, `bilinear_df_dx`,
`bilinear_df_du` and `model_from_initial` are the reference's one-point
forms on one shared model.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .library import (control_powers, diff_library_powers, diff_lift_controls,
                      lift_controls, size_of_library)
from ..utils.linalg import cx_mm


@dataclasses.dataclass(frozen=True)
class BilinearModel:
    """A: (dim_x, dim_x) constant-monomial operator; N: (dim_x, Lm, dim_x)
    unpacked control operator, N[:, l, :] acting on f_l(u) * x. A lane
    batch of operators (one per lane, a streaming refit's) carries a
    leading axis B on both: A (B, dim_x, dim_x), N (B, dim_x, Lm, dim_x).
    A block of the operator's rows (a tensor-parallel rank's, A (rows,
    dim_x), N (rows, Lm, dim_x)) is a model of those output rows."""

    A: torch.Tensor
    N: torch.Tensor
    dim_u: int
    order: int

    @property
    def dim_x(self) -> int:
        return self.A.shape[-1]

    @property
    def polyu_dim(self) -> int:
        return self.N.shape[-2]

    @property
    def per_lane(self) -> bool:
        return self.A.dim() == 3

    @classmethod
    def from_stacked(cls, A_op, N_op, dim_u: int, order: int) -> "BilinearModel":
        """Build from the hstacked `[A | N_1 | N_2 | ...]` operator layout of
        the discretizer and DMDc (column l*dim_x + j multiplies f_l(u) x_j),
        or from a block of its rows."""
        dim_x = A_op.shape[-1]
        polyu_dim = N_op.shape[-1] // dim_x
        if size_of_library(order, dim_u) - 1 != polyu_dim:
            raise ValueError("Dimension mismatch when wrapping a model operator.")
        return cls(A=A_op, N=N_op.reshape(*N_op.shape[:-1], polyu_dim, dim_x),
                   dim_u=dim_u, order=order)

    def lib_powers(self) -> np.ndarray:
        return control_powers(self.order, self.dim_u)[1:]

    def lift_u(self, us: torch.Tensor) -> torch.Tensor:
        """(dim_u, ...) controls -> (Lm, ...) non-constant monomials."""
        return lift_controls(us, self.lib_powers())


def model_along_traj(model: BilinearModel, X: torch.Tensor, U: torch.Tensor):
    """Per-step affine models along each lane's guess trajectory.

    :param X: (B, dim_x, H) complex states; :param U: (B, dim_u, H) controls.
    With a shared operator the contractions broadcast it over the lanes (no
    B-fold copy); with a lane batch of operators they are batched products.
    A model of a block of the operator's rows gives those rows of each
    output (rows in place of the first dim_x below).
    :return: A_s (B, H, dim_x, dim_x), B_s (B, H, dim_x, dim_u),
        Delta_s (B, H, dim_x). The model is linear in x, so
        Delta_t = -B_t u_t exactly.
    """
    B, dim_x, H = X.shape
    rows = model.A.shape[-2]
    Lm = model.polyu_dim
    Ut = U.transpose(0, 1)                                   # (dim_u, B, H)
    polyu = model.lift_u(Ut)                                 # (Lm, B, H)
    dpowers, dcoefs = diff_library_powers(model.order, model.dim_u)
    dpolyu = diff_lift_controls(Ut, dpowers, dcoefs)         # (dim_u, Lm, B, H)
    # A_t = A + sum_l f_l(u_t) N_l
    lead = model.A.shape[:-2]                                # () or (B,)
    N_flat = model.N.transpose(-3, -2).reshape(*lead, Lm, rows * dim_x)
    A0 = model.A[:, None] if model.per_lane else model.A
    A_s = A0 + cx_mm(polyu.permute(1, 2, 0), N_flat).reshape(B, H, rows, dim_x)
    # (N x)_t[:, l] = N[:, l, :] @ x_t
    NX = cx_mm(model.N.reshape(*lead, rows * Lm, dim_x), X)  # (B, rows*Lm, H)
    NX = NX.reshape(B, rows, Lm, H).permute(0, 3, 1, 2)     # (B, H, rows, Lm)
    # B_t = (N x)_t @ (d f / d u)_t^T
    B_s = cx_mm(NX, dpolyu.permute(2, 3, 1, 0))              # (B, H, dim_x, dim_u)
    D_s = -cx_mm(B_s, U.transpose(1, 2)[..., None])[..., 0]
    return A_s, B_s, D_s


def _polyu(model: BilinearModel, u: torch.Tensor) -> torch.Tensor:
    """(Lm,) monomials of one control u (dim_u,), in the operator's dtype."""
    return model.lift_u(u.reshape(-1)).to(model.N.dtype)


def bilinear_f(model: BilinearModel, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """x+ = A x + sum_l f_l(u) N_l x for one state x (dim_x,) and control u."""
    x = x.to(model.N.dtype)
    return model.A @ x + torch.einsum("l,xly,y->x", _polyu(model, u), model.N, x)


def bilinear_df_dx(model: BilinearModel, u: torch.Tensor) -> torch.Tensor:
    """d f / d x = A + sum_l f_l(u) N_l: (dim_x, dim_x)."""
    return model.A + torch.einsum("l,xly->xy", _polyu(model, u), model.N)


def bilinear_df_du(model: BilinearModel, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """d f / d u = sum_l (N_l x) d f_l / d u: (dim_x, dim_u)."""
    dpowers, dcoefs = diff_library_powers(model.order, model.dim_u)
    dpolyu = diff_lift_controls(u.reshape(-1), dpowers, dcoefs)      # (dim_u, Lm)
    Nx = torch.einsum("xly,y->xl", model.N, x.to(model.N.dtype))
    return Nx @ dpolyu.T.to(Nx.dtype)


def model_from_initial(model: BilinearModel, X: torch.Tensor, U: torch.Tensor):
    """The step-0 linearization frozen across the horizon: the affine model
    at (X[:, 0], U[:, 0]) tiled H times.

    :param X: (dim_x, H) states; :param U: (dim_u, H) controls.
    :return: A_s (H, dim_x, dim_x), B_s (H, dim_x, dim_u), Delta_s (H, dim_x),
        with Delta = f(x, u) - A_t x - B_t u.
    """
    H = X.shape[1]
    x, u = X[:, 0], U[:, 0]
    A0 = bilinear_df_dx(model, u)
    B0 = bilinear_df_du(model, x, u)
    d0 = bilinear_f(model, x, u) - (A0 @ x.to(A0.dtype) + B0 @ u.to(B0.dtype))
    tile = lambda a: a.expand(H, *a.shape).clone()
    return tile(A0), tile(B0), tile(d0)
