"""Plain reference problem of the `not_state` configuration: one qubit
steered from (nearly) |0><0| to |1><1| through an ideal RWA model on a
detuned plant (MPC4quantum `test_mpc4quantum.py:607-703`, arXiv:2201.05266).

Built from the configuration file's numbers alone; see mpc_plain for the
loop."""

from __future__ import annotations

import numpy as np

from .mpc_plain import Problem

SX = np.array([[0, 1], [1, 0]], complex)
SZ = np.array([[1, 0], [0, -1]], complex)


def rx(theta: float) -> np.ndarray:
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return np.array([[c, -1j * s], [-1j * s, c]])


def problem(cfg: dict) -> Problem:
    wq, H, n_steps = cfg["wq"], cfg["horizon"], cfg["n_steps"]
    sat = cfg["sat"]
    # rotating frame at the drive: the model's drift is 0, the plant's is
    # its detuning from the drive
    model_H = [0.5 * (wq - wq) * SZ, 0.5 * SX]
    plant_H = [0.5 * (wq * cfg["plant_detune"] - wq) * SZ, 0.5 * SX]
    R0 = rx(cfg["rho0_theta"])
    rho0 = (R0 @ np.diag([1.0, 0.0]).astype(complex) @ R0.conj().T).flatten()
    targ = np.diag([0.0, 1.0]).astype(complex).flatten()
    Q = np.diag([1.0, 0, 0, 1]).astype(complex)
    return Problem(model_H=model_H, plant_H=plant_H, dt=cfg["dt"], horizon=H, n_steps=n_steps,
                   order=cfg["order"], x0=rho0, target=targ,
                   X_targ=np.tile(targ[:, None], (1, n_steps + H + 1)),
                   U_targ=np.zeros((1, n_steps + H)), Q=Q, Qf=Q,
                   R=np.eye(1) * cfg["R_sat2"] / sat ** 2, sat=sat, du=cfg["du_sat"] * sat)
