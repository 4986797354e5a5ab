"""Quantum plant with exact piecewise-constant propagation (counterpart of
mpc4quantum_tpu/plants/quantum.py), batched over lanes.

One step is rho' = U rho U^H with U = exp(-i dt H(u)).

Observation: the full vec(rho) plus complex Gaussian noise of scale sigma,
or, with e_ops set, the expectation values tr(E_i rho) plus noise, mapped
back to a state estimate through the dual frame (`quantum_observe`).
Noise is data: the caller passes it, or draws it with a torch.Generator
of its own; nothing here draws from a global stream.

Steps: the fleet runner's `QuantumPlant.step` takes its propagators from one
`expm_small` launch; `quantum_step` is the reference's Pade form
(ops.expm.expm_pade, JAX mpc()'s default plant step) and
`quantum_step_taylor` its fixed-squaring Taylor form.

Measurement adapters (`lift_kind`, a `LiftKind` value), all batched over
lanes, with `lift_state` / `proj_state` the reference's free functions:
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
import enum
import math
from typing import Optional

import numpy as np
import torch

from ..kernels.expm import expm_small
from ..ops.expm import expm_pade, expm_taylor, propagators_from_controls
from ..utils.linalg import pinv
from .base import Plant, box_norm_bound, default_dtype, generator_at, static_field



class LiftKind(str, enum.Enum):
    """The reference's adapter names; a value is the string a plant's
    `lift_kind` holds (LiftKind.TRUNCATE == "truncate")."""

    IDENTITY = "identity"
    TRUNCATE = "truncate"            # d-level plant observed in a k-level subspace
    PARTIAL_TRACE = "partial_trace"  # bipartite plant observed per subsystem


LIFT_KINDS = tuple(kind.value for kind in LiftKind)


@dataclasses.dataclass(frozen=True)
class QuantumPlant(Plant):
    """d rho/dt = -i[H0 + sum_i u_i H1_i, rho]. A lane batch carries a
    leading axis on every field: H0 (B, d, d), H1s (B, dim_u, d, d),
    sigma (B,) measurement-noise scale, and where the plant is observed
    through e_ops, e_obs (B, n_e, d^2) (exps = e_obs @ vec(rho)) and its
    dual frame e_dual (B, d^2, n_e); both None otherwise. `lift_kind` (one
    of LIFT_KINDS) and `lift_dim` (the subspace dimension of "truncate")
    are settings shared by every lane."""

    H0: torch.Tensor
    H1s: torch.Tensor
    sigma: torch.Tensor
    e_obs: Optional[torch.Tensor] = None
    e_dual: Optional[torch.Tensor] = None
    lift_kind: str = static_field("identity")
    lift_dim: int = static_field(0)

    def __post_init__(self):
        if isinstance(self.lift_kind, LiftKind):
            object.__setattr__(self, "lift_kind", self.lift_kind.value)
        if self.lift_kind not in LIFT_KINDS:
            raise ValueError(f"lift_kind={self.lift_kind!r} is not one of {LIFT_KINDS}")

    @property
    def dim_s(self) -> int:
        return self.H0.shape[-1]

    @property
    def dim_u(self) -> int:
        return self.H1s.shape[-3]

    @property
    def n_obs(self) -> int:
        """Length of one observation: n_e with e_ops, else dim_e = d^2."""
        return self.e_obs.shape[-2] if self.e_obs is not None else self.dim_s ** 2

    @classmethod
    def create(cls, H0, H1s, sigma: float = 0.0, e_ops=None, lift_kind: str = "identity",
               lift_dim: int = 0, device="cuda", dtype=None) -> "QuantumPlant":
        """One plant on `device`, the card unless the caller asks for the
        CPU, in `dtype` (the real dtype; `base.default_dtype` when None:
        float32 on the card, float64 elsewhere).

        :param e_ops: None, or a sequence / (n_e, d, d) stack of measurement
            operators: the plant is then observed through tr(E_i rho).
            e_dual = pinv(e_obs) is taken in float64 (`utils.linalg.pinv`,
            the reference's cut) and then cast.
        """
        def cx(a):
            return a.to(torch.complex128) if torch.is_tensor(a) else \
                torch.from_numpy(np.array(a, dtype=complex))

        H0, H1s = cx(H0), cx(H1s)
        e_obs = e_dual = None
        if e_ops is not None:
            E = cx(e_ops)
            # tr(E rho) = sum_ab E[a, b] rho[b, a]; row-major vec(rho)[b d + a] = rho[b, a]
            e_obs = E.transpose(-1, -2).reshape(E.shape[0], -1)
            e_dual = pinv(e_obs)
        plant = cls(H0=H0, H1s=H1s, sigma=torch.tensor(float(sigma), dtype=torch.float64),
                    e_obs=e_obs, e_dual=e_dual, lift_kind=lift_kind, lift_dim=lift_dim)
        return plant.to(device, default_dtype(device, dtype))

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


def step_unitaries(plant, u: torch.Tensor, dt: float, taylor_k: int,
                   max_squarings: int) -> torch.Tensor:
    """U_b = exp(-i dt H_b) from one `expm_small` launch at d; any plant
    with H0 and H1s (quantum, synthesis)."""
    return expm_small((-1j * dt) * generator_at(plant.H0, plant.H1s, u), taylor_k=taylor_k,
                      max_squarings=max_squarings)


def conjugate(U: torch.Tensor, rho_vec: torch.Tensor) -> torch.Tensor:
    """rho' = U rho U^H on row-major vec(rho) of shape (B, d*d)."""
    d = U.shape[-1]
    rho = rho_vec.reshape(-1, d, d).to(U.dtype)
    return (U @ rho @ U.conj().transpose(-1, -2)).reshape(rho_vec.shape)


def lift_state(plant: QuantumPlant, x: torch.Tensor) -> torch.Tensor:
    """Experiment state -> model space through the plant's adapter."""
    return plant.lift(x)


def proj_state(plant: QuantumPlant, z: torch.Tensor) -> torch.Tensor:
    """Model space -> experiment state through the plant's adapter."""
    return plant.proj(z)


def quantum_step(plant: QuantumPlant, rho_vec: torch.Tensor, u: torch.Tensor,
                 dt: float) -> torch.Tensor:
    """One exact ZOH step rho' = U rho U^H, U = exp(-i dt H(u)) by the Pade
    expm (plain PyTorch): the reference mpc()'s default plant step. One
    plant (rho_vec (d^2,), u (dim_u,)) or a lane batch ((B, d^2), (B, dim_u))."""
    return conjugate(expm_pade((-1j * dt) * generator_at(plant.H0, plant.H1s, u)), rho_vec)


def quantum_step_taylor(plant: QuantumPlant, rho_vec: torch.Tensor, u: torch.Tensor,
                        dt: float, fixed_squarings: int = 4, order: int = 16) -> torch.Tensor:
    """One exact ZOH step per lane with the fixed-squaring Taylor expm;
    accurate while ||dt H(u)||_1 <= 2^fixed_squarings (taylor_norm_bound)."""
    U = expm_taylor((-1j * dt) * generator_at(plant.H0, plant.H1s, u), order=order,
                    fixed_squarings=fixed_squarings)
    return conjugate(U, rho_vec)


def taylor_norm_bound(plant, dt: float, sat) -> float:
    """Worst-case ||dt H(u)||_1 over the control box |u| <= sat, taken over
    every lane of a batch: sizes the expm's Taylor degree and squarings.
    Any plant with H0 and H1s (quantum, synthesis)."""
    return box_norm_bound(plant.H0, plant.H1s, dt, sat)


def quantum_expectations(plant: QuantumPlant, xs: torch.Tensor) -> torch.Tensor:
    """tr(E_i rho) of the plant's e_ops.

    :param xs: one plant: (d^2,) or (d^2, n) vec(rho), giving (n_e,) or
        (n_e, n); a lane batch (e_obs of shape (B, n_e, d^2)): (B, d^2),
        giving (B, n_e).
    """
    if plant.e_obs is None:
        raise ValueError("plant has no e_ops configured")
    xs = xs.to(plant.e_obs.dtype)
    if plant.e_obs.dim() == 2:
        return plant.e_obs @ xs
    return (plant.e_obs @ xs[..., None])[..., 0]


def quantum_observe(plants: QuantumPlant, x: torch.Tensor,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Observe a lane batch as a device would: without e_ops x + sigma
    noise; with e_ops the expectations plus sigma noise, re-seeded into a
    state estimate e_dual @ (e_obs x + sigma noise) (exact up to the noise
    when the e_ops span the operator space, least squares otherwise). The
    fleet runner's `observe_fn`.

    :param x: (B, d^2); :param noise: (B, n_obs) complex standard normal
        draws (real and imaginary parts each N(0, 1)), or None.
    """
    scale = lambda: plants.sigma.reshape(-1, 1) * noise
    if plants.e_obs is None:
        return x if noise is None else x + scale()
    exps = quantum_expectations(plants, x)
    if noise is not None:
        exps = exps + scale()
    return (plants.e_dual @ exps[..., None])[..., 0]


def quantum_simulate(plant: QuantumPlant, x0: torch.Tensor, us: torch.Tensor, dt: float,
                     noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None, interp: str = "zoh",
                     substeps: int = 16) -> torch.Tensor:
    """Propagate one plant over a control trajectory and return every state.

    All n S propagators come from one `expm_small` call
    (`ops.expm.propagators_from_controls`: the Taylor budget of a host-side
    norm bound of these controls); the conjugations run in order.

    :param x0: (d^2,) vec(rho); :param us: (dim_u, n) controls.
    :param noise: None, or (n_out, n + 1) complex standard normal draws
        added at scale sigma to the returned trajectory; or draw them from
        `generator` (real parts first, then imaginary).
    :param interp: "zoh" (piecewise constant, one propagator a step) or
        "linear": step k ramps u_k -> u_{k+1} (the last holds u_{n-1}),
        split into `substeps` segments each propagated at its midpoint
        control (exponential midpoint rule, O((dt/S)^2) a step).
    :return: (d^2, n + 1) states including x0, or with e_ops the (n_e, n + 1)
        expectation trajectory, noise added in observation space.
    """
    if interp not in ("zoh", "linear"):
        raise ValueError(f"interp={interp!r}: 'zoh' or 'linear'")
    d = plant.dim_s
    us = us.reshape(plant.dim_u, -1)
    if interp == "linear":
        S = int(substeps)
        us_next = torch.cat([us[:, 1:], us[:, -1:]], dim=1)
        frac = (torch.arange(S, dtype=us.dtype, device=us.device) + 0.5) / S
        u_eff = (us[:, :, None] + (us_next - us)[:, :, None] * frac).reshape(us.shape[0], -1)
        dt_eff = dt / S
    else:
        S, u_eff, dt_eff = 1, us, dt
    Us = propagators_from_controls(plant.H0, plant.H1s, u_eff, dt_eff)
    rho = x0.reshape(d, d).to(Us.dtype)
    rhos = [rho]
    Uh = Us.conj().transpose(-1, -2)
    for k in range(Us.shape[0]):
        rho = Us[k] @ rho @ Uh[k]
        if (k + 1) % S == 0:
            rhos.append(rho)
    xs = torch.stack(rhos).reshape(len(rhos), d * d).T
    if plant.e_obs is not None:
        xs = quantum_expectations(plant, xs)
    if noise is None and generator is not None:
        draw = lambda: torch.randn(xs.shape, generator=generator, dtype=xs.real.dtype,
                                   device=xs.device)
        noise = torch.complex(draw(), draw())
    if noise is not None:
        xs = xs + plant.sigma * noise.to(xs.dtype)
    return xs
