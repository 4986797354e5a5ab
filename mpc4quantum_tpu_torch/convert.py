"""Carry a scenario and its plant batch across from numpy arrays, e.g. the
JAX package's Scenario and lane batch after `np.asarray` on the JAX side, so
the port and the reference can run on the same data. Nothing here sees a
JAX object.
"""

from __future__ import annotations

import numpy as np
import torch

from .mpc.driver import MPCConfig
from .plants.quantum import QuantumPlant
from .presets import Scenario, scenario_from_arrays
from .solvers.boxqp import BoxQPParams


def _plant(H0, H1s, sigma) -> QuantumPlant:
    return QuantumPlant(H0=torch.tensor(np.asarray(H0, complex)),
                        H1s=torch.tensor(np.asarray(H1s, complex)),
                        sigma=torch.tensor(np.asarray(sigma, float)))


def scenario_from_numpy(name: str, *, x0, A, X_targ, U_targ, Q, R, Qf, sat, du,
                        target_state, config: dict, plant, plants, device=None,
                        dtype: torch.dtype = torch.float64) -> tuple[Scenario, QuantumPlant]:
    """:param A: the DMDc operator [A_x | A_u] (dim_x, dim_x * L).
    :param config: MPCConfig fields as numbers, with "qp_params" a dict of
        BoxQPParams fields.
    :param plant: nominal (H0 (d, d), H1s (dim_u, d, d), sigma ()).
    :param plants: lane batch (H0 (B, d, d), H1s (B, dim_u, d, d), sigma (B,)).
    :param dtype: real dtype of the result; complex arrays take its partner.
    :return: (Scenario, QuantumPlant lane batch) on `device`.
    """
    cfg = dict(config)
    cfg["qp_params"] = BoxQPParams(**cfg.get("qp_params", {}))
    sc = scenario_from_arrays(
        name, x0=x0, A=A, X_targ=X_targ, U_targ=U_targ, Q=Q, R=R, Qf=Qf, sat=sat, du=du,
        target_state=target_state, config=MPCConfig(**cfg), plant=_plant(*plant),
        device=device, dtype=dtype)
    return sc, _plant(*plants).to(device, dtype)
