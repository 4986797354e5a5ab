"""Plain reference problem of the `cnot_state` configuration: an
always-coupled qubit pair (Z (x) Z) driven by Y1, Y2 and Z1 from a slightly
rotated |00> towards |01><01| along a ramped target (MPC4quantum
`test_mpc4quantum.py:399-502`, arXiv:2201.05266).

Built from the configuration file's numbers alone; see mpc_plain for the
loop."""

from __future__ import annotations

import numpy as np

from .mpc_plain import Problem
from .not_state import SZ, rx

SY = np.array([[0, -1j], [1j, 0]], complex)
I2 = np.eye(2, dtype=complex)


def problem(cfg: dict) -> Problem:
    H, n_steps, sat = cfg["horizon"], cfg["n_steps"], cfg["sat"]
    H_list = [np.kron(SZ, SZ), np.kron(SY, I2), np.kron(I2, SY), np.kron(SZ, I2)]
    ground = np.diag([1.0, 0.0]).astype(complex)
    th = cfg["rho0_theta"]
    rho_a, rho_b = (R @ ground @ R.conj().T for R in (rx(-th), rx(th)))
    targ = np.kron(np.diag([1.0, 0.0]), np.diag([0.0, 1.0])).astype(complex).flatten()
    ramp = np.array([min(1.0, 2 * k / n_steps) for k in range(n_steps + H + 1)])
    Qd = np.zeros(16)
    Qd[[0, 5, 10, 15]] = 1.0
    Q = np.diag(Qd).astype(complex)
    return Problem(model_H=H_list, plant_H=H_list, dt=cfg["dt"], horizon=H, n_steps=n_steps,
                   order=cfg["order"], x0=np.kron(rho_a, rho_b).flatten(), target=targ,
                   X_targ=targ[:, None] * ramp[None, :], U_targ=np.zeros((3, n_steps + H)),
                   Q=Q, Qf=Q, R=np.eye(3) * cfg["R"], sat=sat, du=cfg["du_sat"] * sat)
