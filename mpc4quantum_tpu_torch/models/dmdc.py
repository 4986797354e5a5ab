"""Read-only DMDc model container (counterpart of the `DMDcModel` part of
mpc4quantum_tpu/models/dmdc.py): y = A_x x + A_u u with A = [A_x | A_u]."""

from __future__ import annotations

import dataclasses

import torch

from ..utils.linalg import cx_mm


@dataclasses.dataclass(frozen=True)
class DMDcModel:
    A: torch.Tensor  # (dim_y, dim_x + dim_u)
    dim_y: int
    dim_x: int
    dim_u: int


def dmdc_from_operator(A0: torch.Tensor, dim_y: int, dim_x: int, dim_u: int) -> DMDcModel:
    return DMDcModel(A=A0, dim_y=dim_y, dim_x=dim_x, dim_u=dim_u)


def get_discrete(model: DMDcModel):
    """(A_x, A_u) views."""
    return model.A[: model.dim_y, : model.dim_x], model.A[: model.dim_y, model.dim_x:]


def predict(model: DMDcModel, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """y (dim_y, n) from x (dim_x, n) and u (dim_u, n); n may be a lane batch."""
    A_x, A_u = get_discrete(model)
    return cx_mm(A_x, x.reshape(model.dim_x, -1)) + cx_mm(A_u, u.reshape(model.dim_u, -1))
