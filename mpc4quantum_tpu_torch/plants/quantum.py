"""Quantum plant with exact piecewise-constant propagation (counterpart of
mpc4quantum_tpu/plants/quantum.py), batched over lanes.

One step is rho' = U rho U^H with U = exp(-i dt H(u)). Only the identity
measurement adapter is ported: model space equals experiment space.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.expm import expm_taylor


@dataclasses.dataclass(frozen=True)
class QuantumPlant:
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

    def to(self, device=None, dtype=None) -> "QuantumPlant":
        """Move to a device; `dtype` is the real dtype (float32/float64)."""
        cdtype = None if dtype is None else complex_dtype(dtype)
        return QuantumPlant(H0=self.H0.to(device, cdtype),
                            H1s=self.H1s.to(device, cdtype),
                            sigma=self.sigma.to(device, dtype))

    def __getitem__(self, idx) -> "QuantumPlant":
        """Lane slice of a batch."""
        return QuantumPlant(H0=self.H0[idx], H1s=self.H1s[idx], sigma=self.sigma[idx])


def complex_dtype(real_dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if real_dtype == torch.float64 else torch.complex64


def lift_state(plant: QuantumPlant, x: torch.Tensor) -> torch.Tensor:
    """Experiment state -> model space (identity adapter)."""
    return x


def proj_state(plant: QuantumPlant, z: torch.Tensor) -> torch.Tensor:
    """Model space -> experiment state (identity adapter)."""
    return z


def step_hamiltonians(plant: QuantumPlant, u: torch.Tensor) -> torch.Tensor:
    """H_b = H0_b + sum_i u_bi H1_bi for u (B, dim_u): (B, d, d)."""
    return plant.H0 + torch.sum(u[:, :, None, None] * plant.H1s, dim=1)


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


def taylor_norm_bound(plant: QuantumPlant, dt: float, sat) -> float:
    """Worst-case ||dt H(u)||_1 over the control box |u| <= sat, taken over
    every lane of a batch: sizes the expm's Taylor degree and squarings."""
    one_norm = lambda M: float(np.max(np.sum(np.abs(M), axis=-2)))
    H0 = plant.H0.detach().cpu().numpy()
    H1s = plant.H1s.detach().cpu().numpy()
    sat_v = np.broadcast_to(np.asarray(sat, float), (H1s.shape[-3],))
    return abs(float(dt)) * (one_norm(H0) + sum(s * one_norm(H1s[..., k, :, :])
                                                 for k, s in enumerate(sat_v)))
