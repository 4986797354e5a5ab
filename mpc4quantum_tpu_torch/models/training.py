"""Data-driven model training (counterpart of
mpc4quantum_tpu/models/training.py): offline DMDc fits over a grid of
rcond values, the best chosen by closed-loop rollout prediction loss; the
candidates are fit and rolled out together, batched over the grid. The fit
runs in float64 (complex128 on complex data) whatever the data's dtype:
in float32 the sweep's pinv inverts rounding, and on a qubit's
Blackman-drive data its least loss stays above 1e-3."""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.library import krtimes
from ..utils.linalg import pinv
from .dmdc import discrep_from_data, models_to


def prediction_loss(A: torch.Tensor, dim_x: int, X2: torch.Tensor, X1: torch.Tensor,
                    UL1: torch.Tensor) -> torch.Tensor:
    """||X2 - X2_hat||_F of the model rolled forward from X1[:, 0] on its
    own predictions, controls from the lifted data.

    :param A: (..., dim_y, dim_x + dim_lift dim_x) stacked operators (a
        leading grid axis rolls several models at once).
    :param X2, X1: (dim_x, n) snapshots; :param UL1: (dim_lift, n) lifted controls.
    :return: (...,) losses.
    """
    A_x, A_u = A[..., :dim_x], A[..., dim_x:]
    x = X1[:, 0].to(A.dtype).expand(A.shape[:-2] + (dim_x,))
    preds = []
    for t in range(UL1.shape[1]):
        ux = (UL1[:, t, None].to(A.dtype) * x[..., None, :]).reshape(x.shape[:-1] + (-1,))
        x = (A_x @ x[..., None])[..., 0] + (A_u @ ux[..., None])[..., 0]
        preds.append(x)
    X2_hat = torch.stack(preds, dim=-1)
    return torch.sqrt((X2.to(A.dtype) - X2_hat).abs().pow(2).sum(dim=(-2, -1)))


def train_model(X2: torch.Tensor, X1: torch.Tensor, UL1: torch.Tensor, rconds=None,
                capacity: Optional[int] = None):
    """Fit DiscrepDMDc over an rcond grid and keep the fit of least
    prediction loss.

    :param X2, X1: (dim_x, n) successor / current snapshots.
    :param UL1: (dim_lift, n) lifted controls aligned with X1; the model's
        input is krtimes(UL1, X1).
    :param rconds: the grid (default logspace(-6, -1, 10)).
    :return: (the best DiscrepDMDc, in the data's dtype (real snapshots
        give a real model), its rcond as a float, the float64 losses (R,)).
    """
    real = X1.real.dtype
    wide = torch.complex128 if X1.is_complex() or X2.is_complex() else torch.float64
    X2, X1 = X2.to(wide), X1.to(wide)
    UL1 = UL1.to(torch.float64)
    if rconds is None:
        rconds = torch.logspace(-6, -1, 10, dtype=torch.float64)
    rconds = torch.as_tensor(rconds, dtype=torch.float64)
    UX1 = krtimes(UL1.to(X1.dtype), X1)
    dim_x = X1.shape[0]
    Z = torch.cat([X1, UX1], dim=0)
    A_grid = X2 @ pinv(Z.expand(len(rconds), *Z.shape), rconds.to(Z.device))
    losses = prediction_loss(A_grid, dim_x, X2, X1, UL1)
    best_rcond = float(rconds[int(torch.argmin(losses))])
    model = discrep_from_data(X2, X1, UX1, rcond=best_rcond, capacity=capacity)
    return models_to(model, dtype=real), best_rcond, losses
