"""Trajectory-local linearization of discrete bilinear models (counterpart
of mpc4quantum_tpu/ops/bilinear.py), batched over lanes.

The model is `x+ = A x + N (f(u) (kr) x)`; along a guess trajectory it
gives the per-step affine models `x_{t+1} = Delta_t + A_t x_t + B_t u_t`
that the condensed QP consumes.
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
    leading axis B on both: A (B, dim_x, dim_x), N (B, dim_x, Lm, dim_x)."""

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
        the discretizer and DMDc (column l*dim_x + j multiplies f_l(u) x_j)."""
        dim_x = A_op.shape[-1]
        polyu_dim = N_op.shape[-1] // dim_x
        if size_of_library(order, dim_u) - 1 != polyu_dim:
            raise ValueError("Dimension mismatch when wrapping a model operator.")
        return cls(A=A_op, N=N_op.reshape(*N_op.shape[:-2], dim_x, polyu_dim, dim_x),
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
    :return: A_s (B, H, dim_x, dim_x), B_s (B, H, dim_x, dim_u),
        Delta_s (B, H, dim_x). The model is linear in x, so
        Delta_t = -B_t u_t exactly.
    """
    B, dim_x, H = X.shape
    Lm = model.polyu_dim
    Ut = U.transpose(0, 1)                                   # (dim_u, B, H)
    polyu = model.lift_u(Ut)                                 # (Lm, B, H)
    dpowers, dcoefs = diff_library_powers(model.order, model.dim_u)
    dpolyu = diff_lift_controls(Ut, dpowers, dcoefs)         # (dim_u, Lm, B, H)
    # A_t = A + sum_l f_l(u_t) N_l
    lead = model.A.shape[:-2]                                # () or (B,)
    N_flat = model.N.transpose(-3, -2).reshape(*lead, Lm, dim_x * dim_x)
    A0 = model.A[:, None] if model.per_lane else model.A
    A_s = A0 + cx_mm(polyu.permute(1, 2, 0), N_flat).reshape(B, H, dim_x, dim_x)
    # (N x)_t[:, l] = N[:, l, :] @ x_t
    NX = cx_mm(model.N.reshape(*lead, dim_x * Lm, dim_x), X)  # (B, dim_x*Lm, H)
    NX = NX.reshape(B, dim_x, Lm, H).permute(0, 3, 1, 2)    # (B, H, dim_x, Lm)
    # B_t = (N x)_t @ (d f / d u)_t^T
    B_s = cx_mm(NX, dpolyu.permute(2, 3, 1, 0))              # (B, H, dim_x, dim_u)
    D_s = -cx_mm(B_s, U.transpose(1, 2)[..., None])[..., 0]
    return A_s, B_s, D_s
