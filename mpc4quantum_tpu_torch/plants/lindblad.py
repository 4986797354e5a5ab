"""Open-system (Lindblad) plant: dissipative master-equation propagation
in Liouville space (counterpart of mpc4quantum_tpu/plants/lindblad.py),
batched over lanes.

    d rho/dt = -i[H0 + sum_i u_i H1_i, rho] + sum_k D[L_k] rho

is propagated by exact ZOH exponentiation of the (non-unitary) Liouvillian,
x+ = exp(dt (A0 + sum_i u_i A_i)) x with x = vec(rho) (row-major). The
exponential of the d^2 x d^2 generator comes from one `expm_small` launch
(d = 2 gives 4 x 4), where the reference runs an XLA Taylor chain: the same
function. The control generators stay Hamiltonian; the dissipators live in
the drift.

Measurement noise of scale sigma is added to the observed vec(rho) by the
driver's default observation. The reference's free functions:
`lindblad_lift` / `lindblad_proj` (the identity), `lindblad_step` (the Pade
expm), `lindblad_step_taylor` (one `expm_small` call) and
`lindblad_simulate` (every propagator of a trajectory from one
`expm_small` call).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..kernels.expm import expm_small
from ..ops.expm import expm_pade, propagators_from_controls
from ..ops.liouville import lindblad_generator, liouville_generator
from .base import Plant, box_norm_bound, generator_at


@dataclasses.dataclass(frozen=True)
class LindbladPlant(Plant):
    """Dissipative bilinear plant over vec(rho) (identity lift and proj).
    The Hamiltonian drift and the dissipator are kept apart, so a detuning
    sweep scales the coherent part and leaves the decay physical. On a lane
    batch: AH0 (B, d^2, d^2) drift -i[H0, .], AD (B, d^2, d^2) the summed
    dissipators, A1s (B, dim_u, d^2, d^2) control generators, sigma (B,)
    measurement-noise scale."""

    AH0: torch.Tensor
    AD: torch.Tensor
    A1s: torch.Tensor
    sigma: torch.Tensor

    drift = "AH0"

    @classmethod
    def create(cls, H0, H1s, c_ops=(), sigma: float = 0.0) -> "LindbladPlant":
        """From (d, d) Hamiltonians and collapse operators L_k, in complex128."""
        return cls(AH0=liouville_generator(H0),
                   AD=lindblad_generator(np.zeros_like(np.asarray(H0)), c_ops),
                   A1s=torch.stack([liouville_generator(H) for H in H1s]),
                   sigma=torch.tensor(float(sigma), dtype=torch.float64))

    @property
    def A0(self) -> torch.Tensor:
        """The full drift Lindbladian."""
        return self.AH0 + self.AD

    @property
    def dim_s(self) -> int:
        return math.isqrt(self.AH0.shape[-1])

    @property
    def dim_u(self) -> int:
        return self.A1s.shape[-3]

    def step(self, x, u, dt: float, taylor_k: int, max_squarings: int) -> torch.Tensor:
        """x' = exp(dt A(u)) x per lane, the exponential from one
        `expm_small` launch at d^2."""
        A = generator_at(self.A0, self.A1s, u)
        E = expm_small(dt * A, taylor_k=taylor_k, max_squarings=max_squarings)
        return (E @ x.to(E.dtype)[..., None])[..., 0]

    def norm_bound(self, dt: float, sat) -> float:
        return lindblad_norm_bound(self, dt, sat)


def lindblad_norm_bound(plant: LindbladPlant, dt: float, sat) -> float:
    """Worst-case ||dt A(u)||_1 over the control box |u| <= sat, over every
    lane of a batch: the Liouvillian analogue of taylor_norm_bound."""
    return box_norm_bound(plant.A0, plant.A1s, dt, sat)


def lindblad_lift(plant: LindbladPlant, x: torch.Tensor) -> torch.Tensor:
    """Identity lift (model space is the experiment's vec(rho))."""
    return x


def lindblad_proj(plant: LindbladPlant, z: torch.Tensor) -> torch.Tensor:
    return z


def _apply(E: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (E @ x.to(E.dtype)[..., None])[..., 0]


def lindblad_step(plant: LindbladPlant, x_vec: torch.Tensor, u: torch.Tensor,
                  dt: float) -> torch.Tensor:
    """One exact ZOH master-equation step x' = exp(dt A(u)) x by the Pade
    expm (plain PyTorch); one plant (x (d^2,), u (dim_u,)) or a lane batch."""
    return _apply(expm_pade(dt * generator_at(plant.A0, plant.A1s, u)), x_vec)


def lindblad_step_taylor(plant: LindbladPlant, x_vec: torch.Tensor, u: torch.Tensor,
                         dt: float, fixed_squarings: int = 4, order: int = 16) -> torch.Tensor:
    """lindblad_step with the exponential from one `expm_small` call at
    (taylor_k = order, max_squarings = fixed_squarings): exact while
    ||dt A(u)||_1 <= 2^fixed_squarings (lindblad_norm_bound); at
    fixed_squarings = 0 the kernel's certificate ||dt A(u)||_1 <= 1 holds
    the caller."""
    A = dt * generator_at(plant.A0, plant.A1s, u)
    m = A.shape[-1]
    E = expm_small(A.reshape(-1, m, m), taylor_k=order, max_squarings=fixed_squarings)
    return _apply(E.reshape(A.shape), x_vec)


def lindblad_simulate(plant: LindbladPlant, x0: torch.Tensor, us: torch.Tensor, dt: float,
                      noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Propagate one plant over a ZOH control trajectory: every propagator
    from one `expm_small` call (ops.expm.propagators_from_controls), the
    steps in order.

    :param x0: (d^2,) vec(rho); :param us: (dim_u, n) controls.
    :param noise: None, or (d^2, n + 1) complex standard normal draws added
        at scale sigma; or draw them from `generator` (real parts first).
    :return: (d^2, n + 1) states including x0.
    """
    Ps = propagators_from_controls(plant.A0, plant.A1s, us, dt, hermitian_generator=False)
    x = x0.to(Ps.dtype)
    xs = [x]
    for P in Ps:
        x = P @ x
        xs.append(x)
    xs = torch.stack(xs, dim=1)
    if noise is None and generator is not None:
        draw = lambda: torch.randn(xs.shape, generator=generator, dtype=xs.real.dtype,
                                   device=xs.device)
        noise = torch.complex(draw(), draw())
    if noise is not None:
        xs = xs + plant.sigma * noise.to(xs.dtype)
    return xs
