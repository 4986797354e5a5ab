"""Carry a scenario and its plant batch across from numpy arrays, e.g. the
JAX package's Scenario, lane batch and DMDc models after `np.asarray` on
the JAX side, so the port and the reference can run on the same data.
Nothing here sees a JAX object.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .models.dmdc import DiscrepDMDc, DMDcModel, HistoryState, OnlineDMDc
from .mpc.driver import MPCConfig
from .mpc.embedded import EmbeddedPlant, EmbeddedProblem
from .plants.base import Plant, complex_dtype
from .plants.classical import ClassicalPlant, Rotor, VanDerPol
from .plants.lindblad import LindbladPlant
from .plants.quantum import QuantumPlant
from .plants.synthesis import SynthesisPlant
from .presets import Scenario, default_dtype, scenario_from_arrays
from .solvers.boxqp import BoxQPParams

PLANT_KINDS = (QuantumPlant, SynthesisPlant, LindbladPlant)


def plant_from_numpy(fields: dict) -> Plant:
    """The plant kind whose tensor field names match the array keys of
    `fields` (H0, H1s, sigma, optionally e_obs and e_dual: quantum; H0,
    H1s: synthesis; AH0, AD, A1s, sigma: Lindblad), in float64 /
    complex128 on the CPU. An optional field (the quantum plant's e_obs,
    e_dual) may be left out or None. A kind's settings (the quantum plant's
    `lift_kind`, a string, and `lift_dim`, an int) may ride along as plain
    values; left out, they take their defaults."""
    given = {k for k, v in fields.items() if v is not None}
    for kind in PLANT_KINDS:
        static = {f.name for f in dataclasses.fields(kind) if f.metadata.get("static")}
        tensors = [f for f in dataclasses.fields(kind) if f.name not in static]
        required = {f.name for f in tensors if f.default is dataclasses.MISSING}
        optional = {f.name for f in tensors} - required
        if required <= given - static <= required | optional:
            arrays = {k: torch.tensor(np.asarray(fields[k], complex if k != "sigma" else float))
                      for k in given - static}
            return kind(**arrays, **{k: fields[k] for k in static if k in fields})
    raise ValueError(f"no plant kind has the fields {sorted(fields)}")


MODEL_KINDS = (HistoryState, DiscrepDMDc, OnlineDMDc, DMDcModel)


def model_from_numpy(fields: dict, device="cuda", dtype: Optional[torch.dtype] = None):
    """A model of models/dmdc.py from its fields as numpy arrays and plain
    numbers, e.g. a JAX model's dataclass fields after `np.asarray`: the
    kind whose field names are exactly the keys (a HistoryState's "inner"
    is itself such a dict; "pbuf" may be None). Integer arrays (count, it,
    n_recorded) keep their kind; complex and real arrays take `dtype`'s
    partners (presets.default_dtype when None) on `device`, the card
    unless the caller asks for the CPU; settings (dims, capacity, discount,
    rcond, every) become Python numbers."""
    dtype = default_dtype(device, dtype)
    for kind in MODEL_KINDS:
        if {f.name for f in dataclasses.fields(kind)} != set(fields):
            continue
        args = {}
        for f in dataclasses.fields(kind):
            v = fields[f.name]
            if f.metadata.get("static"):
                args[f.name] = type(f.default)(np.asarray(v)) if f.default is not \
                    dataclasses.MISSING else int(np.asarray(v))
            elif isinstance(v, dict):
                args[f.name] = model_from_numpy(v, device, dtype)
            elif v is not None:
                a = np.asarray(v)
                t = torch.tensor(a)
                if a.dtype.kind == "c":
                    t = t.to(complex_dtype(dtype))
                elif a.dtype.kind == "f":
                    t = t.to(dtype)
                args[f.name] = t.to(device)
            else:
                args[f.name] = None
        return kind(**args)
    raise ValueError(f"no model kind has the fields {sorted(fields)}")


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


CLASSICAL_KINDS = {"VanDerPol": VanDerPol, "Rotor": Rotor}


def classical_from_numpy(kind: str, param, substeps: int = 8, device="cuda",
                         dtype: Optional[torch.dtype] = None) -> ClassicalPlant:
    """A classical plant of `kind` (CLASSICAL_KINDS: the JAX package's
    constructor names) with its parameter (Van der Pol's mu, the rotor's
    epsilon; the JAX plant closes over it), a number for one plant or an
    array (B,) for a lane batch, on `device` in `dtype`."""
    plant = CLASSICAL_KINDS[kind](0.0, substeps=substeps, device=device, dtype=dtype)
    return dataclasses.replace(plant, param=torch.as_tensor(
        np.asarray(param, float), dtype=plant.param.dtype).to(device))


def embedded_from_numpy(x0, model_A, X_targ, Q, Qf, plant: Optional[Plant] = None,
                        device="cuda", dtype: Optional[torch.dtype] = None
                        ) -> EmbeddedProblem:
    """A JAX EmbeddedProblem's arrays (x0, model_A, X_targ, Q, Qf, real) as
    the port's, on `device` in `dtype` (presets.default_dtype when None);
    `plant`, the complex plant, is wrapped in EmbeddedPlant as it is."""
    dtype = default_dtype(device, dtype)
    t = lambda a: torch.tensor(np.asarray(a, float), dtype=dtype, device=device)
    return EmbeddedProblem(x0=t(x0), model_A=t(model_A), X_targ=t(X_targ), Q=t(Q), Qf=t(Qf),
                           plant=None if plant is None else EmbeddedPlant(plant))


def operator_rows(A, rank: int, n_op: int, device="cuda",
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Rank `rank`'s block of a stacked operator's rows, given as numpy
    (dim_x, dim_z) (e.g. a JAX model's A after `np.asarray`): rows
    [rank dim_x / n_op, (rank + 1) dim_x / n_op), what one rank of
    parallel/tensor.py's "op" axis holds, on `device` in `dtype`'s complex
    partner (presets.default_dtype when None)."""
    A = np.asarray(A)
    if A.shape[0] % n_op:
        raise ValueError(f"dim_x={A.shape[0]} not divisible by {n_op} ranks")
    rows = A.shape[0] // n_op
    block = torch.tensor(np.ascontiguousarray(A[rank * rows:(rank + 1) * rows]))
    return block.to(device, complex_dtype(default_dtype(device, dtype)))
