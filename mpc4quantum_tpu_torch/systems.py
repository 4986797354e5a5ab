"""Physical system definitions used by the ported presets, as plain numpy
arrays (counterpart of mpc4quantum_tpu/systems.py).

The pieces the presets and the training data need: the Pauli matrices,
the ladder operators, the |i><j| measurement basis, the x rotation, the
Blackman pulse, the RWA qubit, the 3-level RWA transmon and the two qubit
pairs (crosstalk, always-on coupling).
"""

from __future__ import annotations

import dataclasses

import numpy as np

SX = np.array([[0, 1], [1, 0]], dtype=complex)
SY = np.array([[0, -1j], [1j, 0]], dtype=complex)
SZ = np.array([[1, 0], [0, -1]], dtype=complex)
I2 = np.eye(2, dtype=complex)


def destroy(n: int) -> np.ndarray:
    return np.diag(np.sqrt(np.arange(1, n)), 1).astype(complex)


def create(n: int) -> np.ndarray:
    return destroy(n).conj().T


def basis_proj(n: int, k: int) -> np.ndarray:
    e = np.zeros((n, n), dtype=complex)
    e[k, k] = 1.0
    return e


def matrix_units(d: int) -> list[np.ndarray]:
    """|i><j| measurement basis, row-major over (i, j)."""
    out = []
    for i in range(d):
        for j in range(d):
            e = np.zeros((d, d), dtype=complex)
            e[i, j] = 1.0
            out.append(e)
    return out


def blackman(ts, t0, tf, dt):
    """A Blackman window pulse on [t0, tf] sampled at the times ts (0
    outside)."""
    M = int((tf - t0) / dt)
    t_interp = np.linspace(t0, tf, M)
    return np.interp(ts, t_interp, np.blackman(M), left=0, right=0)


def rx_rotation(theta: float) -> np.ndarray:
    return np.array(
        [[np.cos(theta / 2), -1j * np.sin(theta / 2)],
         [-1j * np.sin(theta / 2), np.cos(theta / 2)]]
    )


@dataclasses.dataclass(frozen=True)
class RWAQubit:
    """Ideal 2-level qubit in a rotating frame after the RWA:
    H0 = (wQ - wR)/2 sz, H1 = sx/2."""

    wQ: float
    wD: float
    wR: float

    dim_s = 2
    dim_u = 1

    @property
    def H_list(self):
        return [0.5 * (self.wQ - self.wR) * SZ, 0.5 * SX]


@dataclasses.dataclass(frozen=True)
class RWATransmon:
    """3-level transmon driven on resonance: H0 = alpha |2><2|, X and Y
    quadrature drives."""

    alpha: float

    dim_s = 3
    dim_u = 2

    @property
    def H_list(self):
        HX = 0.5 * (create(3) + destroy(3))
        HY = 0.5j * (create(3) - destroy(3))
        return [self.alpha * basis_proj(3, 2), HX, HY]


@dataclasses.dataclass(frozen=True)
class RWACrosstalk:
    """Two qubits with sigma_z (x) sigma_z crosstalk and independent X and Y
    drives. The per-qubit model Hamiltonians (H_list_1, H_list_2) leave the
    crosstalk out - the mismatch between model and plant is the point of
    the scenario - and drive with SX and SY where the plant drives with
    0.5 kron(SX, I) and 0.5 kron(I, SY): the factor of 2 between model and
    plant drive is the reference's."""

    crosstalk: float

    dim_s = 4
    dim_u = 2

    @property
    def H_list(self):
        H0 = 0.5 * self.crosstalk * np.kron(SZ, SZ)
        return [H0, 0.5 * np.kron(SX, I2), 0.5 * np.kron(I2, SY)]

    @property
    def H_list_1(self):
        return [0.0 * I2, SX]

    @property
    def H_list_2(self):
        return [0.0 * I2, SY]


@dataclasses.dataclass(frozen=True)
class RWACoupled:
    """Always-on Z (x) Z coupling with Y1, Y2 and Z1 drives, for entangling
    state preparation."""

    dim_s = 4
    dim_u = 3

    @property
    def H_list(self):
        return [np.kron(SZ, SZ), np.kron(SY, I2), np.kron(I2, SY), np.kron(SZ, I2)]
