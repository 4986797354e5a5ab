"""Step clock: timing bookkeeping of the receding-horizon loop (counterpart
of mpc4quantum_tpu/mpc/clock.py). Plain Python and numpy: the loop needs
only the counts and dt."""

from __future__ import annotations

import dataclasses

import numpy as np


def val_to_str(val) -> str:
    """Filename-safe float encoding, e.g. 0.25 -> '2d5em01'."""
    s = f"{val:.1E}".replace("E", "e").replace(".", "d")
    return s.replace("-", "m").replace("+", "")


@dataclasses.dataclass(frozen=True)
class StepClock:
    dt: float
    horizon: int
    n_steps: int
    measure_freq: int = 1

    @property
    def ts(self) -> np.ndarray:
        return np.linspace(0.0, self.dt * self.n_steps, self.n_steps, endpoint=False)

    def ts_step(self, a_step: int) -> np.ndarray:
        """The times of the measurement window that ends after step a_step."""
        return np.linspace(self.dt * (a_step + 1 - self.measure_freq), self.dt * (a_step + 1),
                           self.measure_freq + 1)

    def ts_horizon(self, a_step: int) -> np.ndarray:
        """The times of the horizon that starts at step a_step."""
        return np.linspace(self.dt * a_step, self.dt * (a_step + self.horizon), self.horizon,
                           endpoint=False)

    def to_string(self) -> str:
        return "_".join(["mf", val_to_str(self.measure_freq), "dt", val_to_str(self.dt),
                         "h", val_to_str(self.horizon), "n", val_to_str(self.n_steps)])
