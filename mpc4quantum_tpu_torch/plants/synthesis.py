"""Gate-synthesis plant: MPC in process-matrix space (counterpart of
mpc4quantum_tpu/plants/synthesis.py), batched over lanes.

The state is the flattened process matrix P = U (x) U^* of dim n^4. One step
right-composes the step's propagator in process space:
P' = kron(U_k, U_k^*) P with U_k = exp(-i dt H(u)), the form of the
reference's `synthesis_step_taylor`. U_k comes from one `expm_small` launch;
the kron and the 4x4 product stay batched torch, as the reference leaves
them outside any kernel.

The reference's free functions: `lift_unitary` / `proj_process` (the
process matrix of a unitary and back, up to global phase),
`synthesis_step` (the Pade expm), `synthesis_step_taylor` (one
`expm_small` call) and `synthesis_simulate` (every propagator of a
trajectory from one `expm_small` call).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..kernels.expm import expm_small
from ..ops.expm import expm_pade, propagators_from_controls
from .base import Plant, generator_at
from .quantum import step_unitaries, taylor_norm_bound


@dataclasses.dataclass(frozen=True)
class SynthesisPlant(Plant):
    """Unitary synthesis dU/dt = -i H(u) U: H0 (B, n, n), H1s (B, dim_u, n, n)
    on a lane batch. It has no sigma, as the reference's has none: the
    advance treats it as noiseless."""

    H0: torch.Tensor
    H1s: torch.Tensor

    @property
    def dim_s(self) -> int:
        return self.H0.shape[-1]

    @property
    def dim_u(self) -> int:
        return self.H1s.shape[-3]

    def step(self, p, u, dt: float, taylor_k: int, max_squarings: int) -> torch.Tensor:
        """P' = kron(U, U^*) P per lane."""
        return compose(step_unitaries(self, u, dt, taylor_k, max_squarings), p)

    def norm_bound(self, dt: float, sat) -> float:
        return taylor_norm_bound(self, dt, sat)


def process_kron(U: torch.Tensor) -> torch.Tensor:
    """kron(U, U^*) per matrix of a (..., n, n) batch: (..., n^2, n^2)."""
    n = U.shape[-1]
    K = U[..., :, None, :, None] * U.conj()[..., None, :, None, :]
    return K.reshape(*U.shape[:-2], n * n, n * n)


def lift_unitary(U_vec: torch.Tensor) -> torch.Tensor:
    """U (..., n^2) -> flat process matrix P = U (x) U^* (..., n^4)."""
    n = math.isqrt(U_vec.shape[-1])
    U = U_vec.reshape(*U_vec.shape[:-1], n, n)
    return process_kron(U).reshape(*U_vec.shape[:-1], n ** 4)


def compose(U: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """P' = kron(U, U^*) P on flat process matrices: U (..., n, n), p
    (..., n^4) with the same leading axes."""
    n2 = U.shape[-1] ** 2
    P = p.reshape(*U.shape[:-2], n2, n2).to(U.dtype)
    return (process_kron(U) @ P).reshape(p.shape)


def proj_process(P_vec: torch.Tensor) -> torch.Tensor:
    """P (..., n^4) -> U (..., n^2) up to global phase. Block (r, c) of P is
    U[r, c] U^*; the block whose own (r, c) entry |U[r, c]|^2 is largest
    (the first of equals), conjugated and divided by that entry's complex
    square root, gives U."""
    n = math.isqrt(math.isqrt(P_vec.shape[-1]))
    lead = P_vec.shape[:-1]
    # blocks[..., r * n + c, a, b] = P[(r a), (c b)]
    blocks = P_vec.reshape(*lead, n, n, n, n).permute(
        *range(len(lead)), -4, -2, -3, -1).reshape(*lead, n * n, n, n)
    i = torch.arange(n * n, device=P_vec.device)
    pivots = blocks[..., i, i // n, i % n]                              # (..., n^2)
    best = pivots.abs().argmax(dim=-1)
    block = torch.take_along_dim(blocks, best[..., None, None, None], dim=-3)[..., 0, :, :]
    pivot = torch.take_along_dim(pivots, best[..., None], dim=-1)
    return (block.conj() / torch.sqrt(pivot)[..., None]).reshape(*lead, n * n)


def synthesis_step(plant: SynthesisPlant, p: torch.Tensor, u: torch.Tensor,
                   dt: float) -> torch.Tensor:
    """One exact ZOH step in process space P' = kron(U, U^*) P, U = exp(-i dt
    H(u)) by the Pade expm (plain PyTorch); one plant or a lane batch."""
    return compose(expm_pade((-1j * dt) * generator_at(plant.H0, plant.H1s, u)), p)


def synthesis_step_taylor(plant: SynthesisPlant, p: torch.Tensor, u: torch.Tensor, dt: float,
                          fixed_squarings: int = 4, order: int = 16) -> torch.Tensor:
    """synthesis_step with U from one `expm_small` call at (taylor_k =
    order, max_squarings = fixed_squarings): exact while ||dt H(u)||_1 <=
    2^fixed_squarings (taylor_norm_bound)."""
    G = (-1j * dt) * generator_at(plant.H0, plant.H1s, u)
    n = G.shape[-1]
    U = expm_small(G.reshape(-1, n, n), taylor_k=order, max_squarings=fixed_squarings)
    return compose(U.reshape(G.shape), p)


def synthesis_simulate(plant: SynthesisPlant, p0: torch.Tensor, us: torch.Tensor,
                       dt: float) -> torch.Tensor:
    """Propagate one plant's process state over a ZOH control trajectory:
    the unitary U0 = proj_process(p0) right-composed with each step's
    propagator (all from one `expm_small` call), every step lifted back.

    :param p0: (n^4,); :param us: (dim_u, n_steps).
    :return: (n^4, n_steps + 1) process trajectory including p0's lift.
    """
    n = plant.dim_s
    Ps = propagators_from_controls(plant.H0, plant.H1s, us, dt)
    U = proj_process(p0).reshape(n, n).to(Ps.dtype)
    Us = [U]
    for P in Ps:
        U = P @ U
        Us.append(U)
    return lift_unitary(torch.stack(Us).reshape(len(Us), n * n)).T
