"""Gate-synthesis plant: MPC in process-matrix space (counterpart of
mpc4quantum_tpu/plants/synthesis.py), batched over lanes.

The state is the flattened process matrix P = U (x) U^* of dim n^4. One step
right-composes the step's propagator in process space:
P' = kron(U_k, U_k^*) P with U_k = exp(-i dt H(u)), the form of the
reference's `synthesis_step_taylor`. U_k comes from one `expm_small` launch;
the kron and the 4x4 product stay batched torch, as the reference leaves
them outside any kernel.

Not ported (not on the fleet path): `proj_process` and `synthesis_simulate`.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .base import Plant
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
        U = step_unitaries(self, u, dt, taylor_k, max_squarings)
        n2 = U.shape[-1] ** 2
        P = p.reshape(-1, n2, n2).to(U.dtype)
        return (process_kron(U) @ P).reshape(p.shape)

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
