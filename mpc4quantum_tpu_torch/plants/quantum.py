"""Quantum plant with exact piecewise-constant propagation (counterpart of
mpc4quantum_tpu/plants/quantum.py), batched over lanes.

One step is rho' = U rho U^H with U = exp(-i dt H(u)).

Measurement adapters (`lift_kind`), all batched over lanes:
  - "identity": model space equals experiment space;
  - "truncate": a d-level plant observed in its first `lift_dim` levels -
    the lift truncates and renormalizes to unit trace, the proj pads the
    small state with zeros back to d x d;
  - "partial_trace": a pair of identical subsystems lifted to the stacked
    single-system states [vec(rho_A); vec(rho_B)], the proj their tensor
    product.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..kernels.expm import expm_small
from ..ops.expm import expm_taylor
from .base import Plant, box_norm_bound, static_field

LIFT_KINDS = ("identity", "truncate", "partial_trace")


@dataclasses.dataclass(frozen=True)
class QuantumPlant(Plant):
    """d rho/dt = -i[H0 + sum_i u_i H1_i, rho]. A lane batch carries a
    leading axis on every field: H0 (B, d, d), H1s (B, dim_u, d, d),
    sigma (B,) measurement-noise scale. `lift_kind` (one of LIFT_KINDS) and
    `lift_dim` (the subspace dimension of "truncate") are settings shared
    by every lane."""

    H0: torch.Tensor
    H1s: torch.Tensor
    sigma: torch.Tensor
    lift_kind: str = static_field("identity")
    lift_dim: int = static_field(0)

    def __post_init__(self):
        if self.lift_kind not in LIFT_KINDS:
            raise ValueError(f"lift_kind={self.lift_kind!r} is not one of {LIFT_KINDS}")

    @property
    def dim_s(self) -> int:
        return self.H0.shape[-1]

    @property
    def dim_u(self) -> int:
        return self.H1s.shape[-3]

    def lift(self, x: torch.Tensor) -> torch.Tensor:
        if self.lift_kind == "truncate":
            return truncate_lift(x, self.dim_s, self.lift_dim)
        if self.lift_kind == "partial_trace":
            return partial_trace_lift(x)
        return x

    def proj(self, z: torch.Tensor) -> torch.Tensor:
        if self.lift_kind == "truncate":
            return truncate_proj(z, self.dim_s, self.lift_dim)
        if self.lift_kind == "partial_trace":
            return tensor_proj(z)
        return z

    def step(self, x, u, dt: float, taylor_k: int, max_squarings: int) -> torch.Tensor:
        """rho' = U rho U^H per lane."""
        return conjugate(step_unitaries(self, u, dt, taylor_k, max_squarings), x)

    def norm_bound(self, dt: float, sat) -> float:
        return taylor_norm_bound(self, dt, sat)


def truncate_lift(rho_vec: torch.Tensor, dim_full: int, dim_sub: int) -> torch.Tensor:
    """vec(rho) (..., dim_full^2) -> the leading dim_sub x dim_sub block,
    renormalized to unit trace (..., dim_sub^2)."""
    rho = rho_vec.reshape(*rho_vec.shape[:-1], dim_full, dim_full)[..., :dim_sub, :dim_sub]
    tr = torch.diagonal(rho, dim1=-2, dim2=-1).sum(dim=-1)
    return (rho / tr[..., None, None]).reshape(*rho_vec.shape[:-1], dim_sub * dim_sub)


def truncate_proj(z: torch.Tensor, dim_full: int, dim_sub: int) -> torch.Tensor:
    """(..., dim_sub^2) -> the state padded with zeros to the full space
    (..., dim_full^2)."""
    rho = torch.zeros(*z.shape[:-1], dim_full, dim_full, dtype=z.dtype, device=z.device)
    rho[..., :dim_sub, :dim_sub] = z.reshape(*z.shape[:-1], dim_sub, dim_sub)
    return rho.reshape(*z.shape[:-1], dim_full * dim_full)


def partial_trace_lift(rho_vec: torch.Tensor) -> torch.Tensor:
    """vec(rho_AB) (..., d^4) -> [vec(rho_A); vec(rho_B)] (..., 2 d^2) for
    identical subsystems, as two traces of the (a, b, a', b') view of
    rho[(a b), (a' b')]."""
    d = math.isqrt(math.isqrt(rho_vec.shape[-1]))
    lead = rho_vec.shape[:-1]
    rho = rho_vec.reshape(*lead, d, d, d, d)
    rho_a = torch.einsum("...ajbj->...ab", rho)
    rho_b = torch.einsum("...jajb->...ab", rho)
    return torch.cat([rho_a.reshape(*lead, d * d), rho_b.reshape(*lead, d * d)], dim=-1)


def tensor_proj(stacked_vec: torch.Tensor) -> torch.Tensor:
    """[vec(rho_A); vec(rho_B)] (..., 2 d^2) -> vec(rho_A (x) rho_B) (..., d^4)."""
    d2 = stacked_vec.shape[-1] // 2
    d = math.isqrt(d2)
    lead = stacked_vec.shape[:-1]
    rho_a = stacked_vec[..., :d2].reshape(*lead, d, d)
    rho_b = stacked_vec[..., d2:].reshape(*lead, d, d)
    kron = rho_a[..., :, None, :, None] * rho_b[..., None, :, None, :]
    return kron.reshape(*lead, d2 * d2)


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
