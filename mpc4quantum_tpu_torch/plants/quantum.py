"""Quantum plant with exact piecewise-constant propagation (counterpart of
mpc4quantum_tpu/plants/quantum.py), batched over lanes.

One step is rho' = U rho U^H with U = exp(-i dt H(u)). Only the identity
measurement adapter is ported: model space equals experiment space.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels.expm import expm_small
from ..ops.expm import expm_taylor
from .base import Plant, box_norm_bound


@dataclasses.dataclass(frozen=True)
class QuantumPlant(Plant):
    """d rho/dt = -i[H0 + sum_i u_i H1_i, rho]. A lane batch carries a
    leading axis on every field: H0 (B, d, d), H1s (B, dim_u, d, d),
    sigma (B,) measurement-noise scale."""

    H0: torch.Tensor
    H1s: torch.Tensor
    sigma: torch.Tensor

    @property
    def dim_s(self) -> int:
        return self.H0.shape[-1]

    @property
    def dim_u(self) -> int:
        return self.H1s.shape[-3]

    def step(self, x, u, dt: float, taylor_k: int, max_squarings: int) -> torch.Tensor:
        """rho' = U rho U^H per lane."""
        return conjugate(step_unitaries(self, u, dt, taylor_k, max_squarings), x)

    def norm_bound(self, dt: float, sat) -> float:
        return taylor_norm_bound(self, dt, sat)


def step_hamiltonians(plant, u: torch.Tensor) -> torch.Tensor:
    """H_b = H0_b + sum_i u_bi H1_bi for u (B, dim_u): (B, d, d)."""
    return plant.H0 + torch.sum(u[:, :, None, None] * plant.H1s, dim=1)


def step_unitaries(plant, u: torch.Tensor, dt: float, taylor_k: int,
                   max_squarings: int) -> torch.Tensor:
    """U_b = exp(-i dt H_b) from one `expm_small` launch at d; any plant
    with H0 and H1s (quantum, synthesis)."""
    return expm_small((-1j * dt) * step_hamiltonians(plant, u), taylor_k=taylor_k,
                      max_squarings=max_squarings)


def conjugate(U: torch.Tensor, rho_vec: torch.Tensor) -> torch.Tensor:
    """rho' = U rho U^H on row-major vec(rho) of shape (B, d*d)."""
    d = U.shape[-1]
    rho = rho_vec.reshape(-1, d, d).to(U.dtype)
    return (U @ rho @ U.conj().transpose(-1, -2)).reshape(rho_vec.shape)


def quantum_step_taylor(plant: QuantumPlant, rho_vec: torch.Tensor, u: torch.Tensor,
                        dt: float, fixed_squarings: int = 4, order: int = 16) -> torch.Tensor:
    """One exact ZOH step per lane with the fixed-squaring Taylor expm;
    accurate while ||dt H(u)||_1 <= 2^fixed_squarings (taylor_norm_bound)."""
    U = expm_taylor((-1j * dt) * step_hamiltonians(plant, u), order=order,
                    fixed_squarings=fixed_squarings)
    return conjugate(U, rho_vec)


def taylor_norm_bound(plant, dt: float, sat) -> float:
    """Worst-case ||dt H(u)||_1 over the control box |u| <= sat, taken over
    every lane of a batch: sizes the expm's Taylor degree and squarings.
    Any plant with H0 and H1s (quantum, synthesis)."""
    return box_norm_bound(plant.H0, plant.H1s, dt, sat)
