"""Carry a scenario and its plant batch across from numpy arrays, e.g. the
JAX package's Scenario and lane batch after `np.asarray` on the JAX side, so
the port and the reference can run on the same data. Nothing here sees a
JAX object.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .mpc.driver import MPCConfig
from .plants.base import Plant
from .plants.lindblad import LindbladPlant
from .plants.quantum import QuantumPlant
from .plants.synthesis import SynthesisPlant
from .presets import Scenario, default_dtype, scenario_from_arrays
from .solvers.boxqp import BoxQPParams

PLANT_KINDS = (QuantumPlant, SynthesisPlant, LindbladPlant)


def plant_from_numpy(fields: dict) -> Plant:
    """The plant kind whose tensor field names are exactly the array keys
    of `fields` (H0, H1s, sigma: quantum; H0, H1s: synthesis; AH0, AD, A1s,
    sigma: Lindblad), in float64 / complex128 on the CPU. A kind's settings
    (the quantum plant's `lift_kind`, a string, and `lift_dim`, an int) may
    ride along as plain values; left out, they take their defaults."""
    for kind in PLANT_KINDS:
        static = {f.name for f in dataclasses.fields(kind) if f.metadata.get("static")}
        names = [f.name for f in dataclasses.fields(kind) if f.name not in static]
        if set(names) == set(fields) - static:
            tensors = {k: torch.tensor(np.asarray(fields[k], complex if k != "sigma" else float))
                       for k in names}
            return kind(**tensors, **{k: fields[k] for k in static if k in fields})
    raise ValueError(f"no plant kind has the fields {sorted(fields)}")


def scenario_from_numpy(name: str, *, x0, A, X_targ, U_targ, Q, R, Qf, sat, du,
                        target_state, config: dict, plant: dict, plants: dict, exit_below=None,
                        device="cuda", dtype: Optional[torch.dtype] = None
                        ) -> tuple[Scenario, Plant]:
    """:param A: the DMDc operator [A_x | A_u] (dim_x, dim_x * L).
    :param config: MPCConfig fields as numbers, with "qp_params" a dict of
        BoxQPParams fields.
    :param plant: the nominal plant's fields by name (plant_from_numpy),
        e.g. {"H0": (d, d), "H1s": (dim_u, d, d), "sigma": ()}, with
        "lift_kind" / "lift_dim" where the adapter is not the identity.
    :param plants: the lane batch's fields, each array with a leading axis B.
    :param exit_below: None, or (target (dim_e,), threshold): the
        reference's distance exit (presets.DistanceExit) as its numbers.
    :param device: the card unless the caller asks for the CPU.
    :param dtype: real dtype of the result (presets.default_dtype when
        None: float32 on the card, float64 on the CPU); complex arrays take
        its partner.
    :return: (Scenario, plant lane batch) on `device`.
    """
    dtype = default_dtype(device, dtype)
    cfg = dict(config)
    cfg["qp_params"] = BoxQPParams(**cfg.get("qp_params", {}))
    sc = scenario_from_arrays(
        name, x0=x0, A=A, X_targ=X_targ, U_targ=U_targ, Q=Q, R=R, Qf=Qf, sat=sat, du=du,
        target_state=target_state, config=MPCConfig(**cfg), plant=plant_from_numpy(plant),
        exit_below=exit_below, device=device, dtype=dtype)
    return sc, plant_from_numpy(plants).to(device, dtype)
