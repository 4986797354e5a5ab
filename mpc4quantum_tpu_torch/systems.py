"""Physical system definitions used by the ported presets, as plain numpy
arrays (counterpart of mpc4quantum_tpu/systems.py).

Only the pieces the `not_state` preset needs are here: the Pauli matrices,
the |i><j| measurement basis, the x rotation and the RWA qubit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

SX = np.array([[0, 1], [1, 0]], dtype=complex)
SY = np.array([[0, -1j], [1j, 0]], dtype=complex)
SZ = np.array([[1, 0], [0, -1]], dtype=complex)
I2 = np.eye(2, dtype=complex)


def matrix_units(d: int) -> list[np.ndarray]:
    """|i><j| measurement basis, row-major over (i, j)."""
    out = []
    for i in range(d):
        for j in range(d):
            e = np.zeros((d, d), dtype=complex)
            e[i, j] = 1.0
            out.append(e)
    return out


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
