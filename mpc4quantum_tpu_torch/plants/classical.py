"""Classical plants integrated by fixed-step RK4 (counterpart of
mpc4quantum_tpu/plants/classical.py), batched over lanes.

A classical plant is an ODE dx/dt = f(t, x, u; param) on a real state with
zero-order-hold (or linearly interpolated) controls, with a Koopman-style
lift and projection where the kind defines one (Van der Pol's
[x1, x2, x1^2, x1^2 x2]). Its parameter (Van der Pol's mu, the rotor's
epsilon) is a tensor field, so a lane batch may carry one per lane; the
right-hand side, lift and projection are settings shared by the lanes.
It steps without an expm: no expm kernel runs and there is no norm bound.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .base import Plant, default_dtype, static_field


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


@dataclasses.dataclass(frozen=True)
class ClassicalPlant(Plant):
    """dx/dt = rhs(t, x, u, param) over a real state. One plant: param ()
    (or (p,)); a lane batch: (B,) (or (B, p)). `rhs` takes x (B, dim_x),
    u (B, dim_u) and the batch's param and returns (B, dim_x); `lift_map`
    and `proj_map` act on (..., dim) along the last axis."""

    param: torch.Tensor
    rhs: Callable = static_field(None)
    lift_map: Callable = static_field(_identity)
    proj_map: Callable = static_field(_identity)
    dim_x: int = static_field(2)
    dim_u: int = static_field(1)
    substeps: int = static_field(8)

    real_state = True
    uses_expm = False
    drift = "param"

    def lift(self, x: torch.Tensor) -> torch.Tensor:
        return self.lift_map(x)

    def proj(self, z: torch.Tensor) -> torch.Tensor:
        return self.proj_map(z)

    def step(self, x, u, dt: float, taylor_k=None, max_squarings=None) -> torch.Tensor:
        """One ZOH interval of RK4 per lane (`substeps` steps): x (B,
        dim_x), u (B, dim_u) -> (B, dim_x). The expm budget is ignored."""
        return rk4_simulate(self, x, u[:, :, None], dt)[:, :, -1]


def rk4_simulate(plant: ClassicalPlant, x0: torch.Tensor, us: torch.Tensor, dt: float,
                 interp: str = "zoh") -> torch.Tensor:
    """Fixed-step RK4 over a control trajectory, `plant.substeps` steps of
    dt / substeps an interval.

    :param x0: one plant: (dim_x,), with us (dim_u, n); a lane batch:
        (B, dim_x), with us (B, dim_u, n).
    :param interp: "zoh" (piecewise constant, the engine's convention) or
        "linear": each RK4 stage of interval k takes u on the segment
        u_k -> u_{k+1}, the last interval holding u_{n-1} (the reference
        CExperiment's interpolated controls).
    :return: (dim_x, n + 1), or (B, dim_x, n + 1), including x0.
    """
    if interp not in ("zoh", "linear"):
        raise ValueError(f"interp={interp!r}: 'zoh' or 'linear'")
    single = x0.dim() == 1
    lanes = plant[None] if single else plant
    x = x0[None] if single else x0
    us = (us[None] if single else us).to(x.dtype)
    h = dt / plant.substeps
    us_next = torch.cat([us[..., 1:], us[..., -1:]], dim=-1) if interp == "linear" else us
    f = lambda t, xx, uu: lanes.rhs(t, xx, uu, lanes.param)
    t0 = torch.zeros((), dtype=x.dtype, device=x.device)
    xs = [x]
    for k in range(us.shape[-1]):
        u0, u1 = us[..., k], us_next[..., k]
        # the stage's control on the segment (u0 itself for zoh)
        u_at = lambda tt: u0 + (u1 - u0) * ((tt - t0) / dt)
        for i in range(plant.substeps):
            t = t0 + i * h
            k1 = f(t, x, u_at(t))
            k2 = f(t + h / 2, x + h / 2 * k1, u_at(t + h / 2))
            k3 = f(t + h / 2, x + h / 2 * k2, u_at(t + h / 2))
            k4 = f(t + h, x + h * k3, u_at(t + h))
            x = x + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        t0 = t0 + dt
        xs.append(x)
    out = torch.stack(xs, dim=-1)
    return out[0] if single else out


def _vdp_rhs(t, x, u, mu):
    x1, x2 = x[:, 0], x[:, 1]
    return torch.stack([x2, -x1 + mu * (1 - x1 ** 2) * x2 + u[:, 0]], dim=-1)


def vdp_lift(x: torch.Tensor) -> torch.Tensor:
    """Van der Pol's Koopman lift [x1, x2, x1^2, x1^2 x2] (..., 2) -> (..., 4)."""
    x1, x2 = x[..., 0], x[..., 1]
    return torch.stack([x1, x2, x1 ** 2, x1 ** 2 * x2], dim=-1)


def vdp_proj(z: torch.Tensor) -> torch.Tensor:
    """The lift's projection back to (x1, x2)."""
    return z[..., :2]


def _rotor_rhs(t, x, u, epsilon):
    omega = 1 + epsilon * u[:, 0]
    return torch.stack([omega * x[:, 1], -omega * x[:, 0]], dim=-1)


def VanDerPol(mu: float, substeps: int = 8, device="cuda", dtype=None) -> ClassicalPlant:
    """The Van der Pol oscillator dx1 = x2, dx2 = -x1 + mu (1 - x1^2) x2 + u
    with its Koopman lift, on `device` (the card unless the caller asks for
    the CPU) in `dtype` (base.default_dtype when None)."""
    dtype = default_dtype(device, dtype)
    return ClassicalPlant(param=torch.tensor(float(mu), dtype=dtype, device=device),
                          rhs=_vdp_rhs, lift_map=vdp_lift, proj_map=vdp_proj, dim_x=2, dim_u=1,
                          substeps=substeps)


def Rotor(epsilon: float, substeps: int = 8, device="cuda", dtype=None) -> ClassicalPlant:
    """A rotation whose frequency the control sets: omega = 1 + epsilon u."""
    dtype = default_dtype(device, dtype)
    return ClassicalPlant(param=torch.tensor(float(epsilon), dtype=dtype, device=device),
                          rhs=_rotor_rhs, dim_x=2, dim_u=1, substeps=substeps)
