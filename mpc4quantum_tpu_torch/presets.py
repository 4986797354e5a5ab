"""Named scenario presets (counterpart of mpc4quantum_tpu/presets.py).

The seven presets:
  - `not_state`, the flagship fleet workload: an ideal-model qubit steered
    |0> -> |1> on a 1%-detuned plant, dt = 1, H = 10, 20 steps,
    sat = 2 pi 0.1, first-step slew 0.5 sat (QP n = 10);
  - `not_state_freq`: the same qubit measured every 5th step, dt = 0.2,
    H = 50, 100 steps, slew 0.1 sat (QP n = 50);
  - `drag_state`: a 3-level transmon |0> -> |1> with a leakage-weighted
    cost, X and Y drives, dt = 0.25, H = 16, 20 steps, sat = 2 pi 0.25
    (QP n = 32);
  - `not_gate`: NOT-gate synthesis in process space (dim 16), dt = 0.05,
    H = 15, sat 1, slew 0.25, exit once the process cost is below 1e-2
    (QP n = 15);
  - `lindblad_state`: the flagship's state preparation on an open system
    (amplitude damping sqrt(gamma) sigma_- in model and plant; QP n = 10);
  - `crosstalk`: two qubits steered through per-qubit models (model space
    dim 8, partial-trace lift) on a plant with Z (x) Z crosstalk (dim 16),
    measured every 2nd step, every step a warm solve, dt = 0.5, H = 20,
    50 steps (QP n = 40);
  - `cnot_state`: entangling state preparation on an always-coupled pair
    (dim 16, three controls) with a ramped target, dt = 0.25, H = 50,
    200 steps (QP n = 150).

Every preset builds its tensors on the card (`device="cuda"`, float32)
unless the caller asks for another device; on the CPU the dtype defaults
to float64 (`default_dtype`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from . import systems
from .models.dmdc import DMDcModel, dmdc_from_operator
from .mpc.driver import MPCConfig
from .ops.liouville import (discretize_homogeneous, lindblad_generator, liouville_generator,
                            vectorize_me)
from .plants.base import Plant, complex_dtype, default_dtype
from .plants.lindblad import LindbladPlant
from .plants.quantum import QuantumPlant
from .plants.synthesis import SynthesisPlant, lift_unitary
from .solvers.boxqp import BoxQPParams
from .systems import SX, matrix_units, rx_rotation


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Everything a fleet run or `mpc(**scenario.mpc_args())` needs, as
    tensors on one device."""

    name: str
    x0: torch.Tensor            # (dim_e,) complex initial state, experiment space
    model: DMDcModel
    plant: Plant                # the nominal plant a lane batch perturbs
    X_targ: torch.Tensor        # (dim_x, n_steps + H + 1) complex
    U_targ: torch.Tensor        # (dim_u, n_steps + H)
    Q: torch.Tensor
    R: torch.Tensor
    Qf: torch.Tensor
    config: MPCConfig
    sat: float
    du: Optional[float]
    target_state: torch.Tensor  # (dim_e,) for the fidelity, experiment space
    # batched (x_next, x_cur, u) -> (B,) bool; None = run every step
    exit_condition: Optional[Callable] = None

    def mpc_args(self) -> dict:
        """The keyword arguments of `mpc(**scenario.mpc_args())`: one
        rollout of the nominal plant."""
        return dict(x0=self.x0, model_state=self.model, plant=self.plant,
                    X_targ=self.X_targ, U_targ=self.U_targ, Q=self.Q, R=self.R, Qf=self.Qf,
                    config=self.config, sat=self.sat, du=self.du,
                    exit_condition=self.exit_condition)


@dataclasses.dataclass(frozen=True)
class DistanceExit:
    """Exit once the *current* state is close to a target:
    ||x_cur - target||^2 < threshold, per lane. The next state is not read:
    the reference's not_gate condition reads its second argument, so a lane
    exits one step after it crosses the threshold."""

    target: torch.Tensor        # (dim_e,) complex, on the scenario's device
    threshold: float

    def __call__(self, x_next, x_cur, u) -> torch.Tensor:
        d = x_cur - self.target
        return (d.conj() * d).real.sum(dim=-1) < self.threshold


def scenario_from_arrays(name, *, x0, A, X_targ, U_targ, Q, R, Qf, sat, du, target_state,
                         config: MPCConfig, plant: Plant, exit_below=None, device="cuda",
                         dtype: Optional[torch.dtype] = None) -> Scenario:
    """Build a Scenario from numpy/tensor arrays, cast to `dtype` (the real
    dtype, `default_dtype` when None; complex arrays take its complex
    partner) on `device`: the card unless the caller asks for the CPU. On a
    machine without a card the default raises; nothing falls back.

    dim_x is A's row count, the model space; x0 and target_state live in
    the plant's experiment space, whose dimension differs from dim_x when
    the plant's lift is not the identity.

    :param exit_below: None, or (target (dim_e,), threshold) of a
        DistanceExit condition.
    """
    dtype = default_dtype(device, dtype)
    cdtype = complex_dtype(dtype)
    cx = lambda a: torch.tensor(np.asarray(a, complex)).to(device, cdtype)
    re = lambda a: torch.tensor(np.asarray(a, float)).to(device, dtype)
    A = cx(A)
    dim_x = A.shape[0]
    return Scenario(
        name=name, x0=cx(x0), model=dmdc_from_operator(A, dim_x, dim_x, A.shape[1] - dim_x),
        plant=plant.to(device, dtype), X_targ=cx(X_targ), U_targ=re(U_targ),
        Q=cx(Q), R=re(R), Qf=cx(Qf), config=config, sat=float(sat),
        du=None if du is None else float(du), target_state=cx(target_state),
        exit_condition=None if exit_below is None else DistanceExit(cx(exit_below[0]),
                                                                    float(exit_below[1])))


def _model_operator(H_list, dim_s, dt, order) -> torch.Tensor:
    basis = matrix_units(dim_s)
    A_cts = [vectorize_me(Hm, basis) for Hm in H_list]
    return discretize_homogeneous(A_cts, dt, order)


def _qubit_not(detune: float, dt: float, order: int):
    """Ideal-model qubit and its detuned plant, started at Rx(1e-4)|0><0|
    and steered to |1><1|: (A, plant, rho0, target, Q)."""
    wq = 2 * np.pi * 4
    qubit = systems.RWAQubit(wQ=wq, wD=wq, wR=wq)
    A = _model_operator(qubit.H_list, 2, dt, order)
    plant_qubit = systems.RWAQubit(wQ=wq * detune, wD=wq, wR=wq)
    plant = QuantumPlant(H0=torch.as_tensor(plant_qubit.H_list[0]),
                         H1s=torch.as_tensor(np.stack([plant_qubit.H_list[1]])),
                         sigma=torch.zeros((), dtype=torch.float64))
    Rx = rx_rotation(1e-4)
    rho0 = (Rx @ np.diag([1.0, 0.0]).astype(complex) @ Rx.conj().T).flatten()
    targ = np.diag([0.0, 1.0]).astype(complex).flatten()
    Q = np.diag([1.0, 0, 0, 1]).astype(complex)
    return A, plant, rho0, targ, Q


def _targets(targ, dim_u, n_steps, H):
    return np.tile(targ[:, None], (1, n_steps + H + 1)), np.zeros((dim_u, n_steps + H))


def not_state(order: int = 2, detune: float = 0.99, device="cuda",
              dtype: Optional[torch.dtype] = None) -> Scenario:
    """The flagship: a qubit steered |0> -> |1> on a 1%-detuned plant (QP n = 10).

    Ideal-model qubit, dt = 1, H = 10, n_steps = 20, sat = 2 pi 0.1,
    du = 0.5 sat."""
    dt, H, n_steps = 1.0, 10, 20
    sat = 2 * np.pi * 0.1
    A, plant, rho0, targ, Q = _qubit_not(detune, dt, order)
    X_targ, U_targ = _targets(targ, 1, n_steps, H)
    return scenario_from_arrays(
        "not_state", x0=rho0, A=A.numpy(), X_targ=X_targ, U_targ=U_targ, Q=Q,
        R=np.eye(1) * (1e-2 / sat ** 2), Qf=Q, sat=sat, du=0.5 * sat, target_state=targ,
        config=MPCConfig(horizon=H, n_steps=n_steps, dt=dt, dim_u=1, order=order),
        plant=plant, device=device, dtype=dtype)


def not_state_freq(order: int = 1, detune: float = 0.99, device="cuda",
                   dtype: Optional[torch.dtype] = None) -> Scenario:
    """The NOT-state qubit measured every 5th step (QP n = 50).

    measure_freq = 5, dt = 0.2, H = 50, n_steps = 100, sat = 2 pi 0.1,
    du = 0.1 sat."""
    dt, H, n_steps = 0.2, 50, 100
    sat = 2 * np.pi * 0.1
    A, plant, rho0, targ, Q = _qubit_not(detune, dt, order)
    X_targ, U_targ = _targets(targ, 1, n_steps, H)
    return scenario_from_arrays(
        "not_state_freq", x0=rho0, A=A.numpy(), X_targ=X_targ, U_targ=U_targ, Q=Q,
        R=np.eye(1) * 1e-2, Qf=Q, sat=sat, du=0.1 * sat, target_state=targ,
        config=MPCConfig(horizon=H, n_steps=n_steps, dt=dt, dim_u=1, order=order,
                         measure_freq=5),
        plant=plant, device=device, dtype=dtype)


def drag_state(order: int = 1, device="cuda", dtype: Optional[torch.dtype] = None) -> Scenario:
    """A 3-level transmon |0> -> |1> with a leakage-penalized cost (QP n = 32).

    The cost recovers DRAG-like pulses: dt = 0.25, H = 16, n_steps = 20,
    sat = 2 pi 0.25, anharmonicity -2 pi 0.1 / dt, du = 0.5 sat."""
    dt, H, n_steps = 0.25, 16, 20
    sat = 2 * np.pi * 0.25
    transmon = systems.RWATransmon(alpha=-2 * np.pi * 0.1 / dt)
    A = _model_operator(transmon.H_list, 3, dt, order)
    plant = QuantumPlant(H0=torch.as_tensor(transmon.H_list[0]),
                         H1s=torch.as_tensor(np.stack(transmon.H_list[1:])),
                         sigma=torch.zeros((), dtype=torch.float64))
    # the qubit block of rho0 is perturbed, as the flagship's is
    Rx = rx_rotation(1e-4)
    rho0 = np.zeros((3, 3), dtype=complex)
    rho0[0, 0] = 1.0
    rho0[:2, :2] = Rx.conj().T @ rho0[:2, :2] @ Rx
    targ = np.zeros((3, 3), dtype=complex)
    targ[1, 1] = 1.0
    targ = targ.flatten()
    # populations of |0> and |1> weighted; |2> is free but targeted at 0
    Qd = np.zeros(9)
    Qd[0] = Qd[4] = 1.0
    Q = np.diag(Qd).astype(complex)
    X_targ, U_targ = _targets(targ, 2, n_steps, H)
    return scenario_from_arrays(
        "drag_state", x0=rho0.flatten(), A=A.numpy(), X_targ=X_targ, U_targ=U_targ, Q=Q,
        R=np.eye(2) * (1e-3 / sat ** 2), Qf=Q, sat=sat, du=0.5 * sat, target_state=targ,
        config=MPCConfig(horizon=H, n_steps=n_steps, dt=dt, dim_u=2, order=order),
        plant=plant, device=device, dtype=dtype)


def not_gate(order: int = 1, n_steps: int = 50, device="cuda",
             dtype: Optional[torch.dtype] = None) -> Scenario:
    """NOT-gate synthesis in process-matrix space, dim 16 (QP n = 15).

    dt = 0.05,
    H = 15, sat = 1, du = 0.25, benchmark control 0.5, Qf = 10 Q, exit
    once the process cost ||P - P_target||^2 < 1e-2.

    At the reference's n_steps = 50 the largest reachable rotation is
    sat n dt = 2.5 rad < pi, so the gate cannot complete and the exit never
    fires; the fleet runs n_steps = 90. The drift is 0 (wQ = wR), so a
    detuning sweep leaves every lane the same."""
    dt, H = 0.05, 15
    sat, du = 1.0, 0.25
    w = np.pi
    H0, H1 = systems.RWAQubit(wQ=w, wD=w, wR=w).H_list
    # process-space generators kron(-i(kron(h, I) - kron(I, h^*)), I_4)
    I2, I4 = np.eye(2), np.eye(4)
    A_cts = [np.kron(-1j * (np.kron(h, I2) - np.kron(I2, h.conj())), I4) for h in (H0, H1)]
    A = discretize_homogeneous(A_cts, dt, order)
    plant = SynthesisPlant(H0=torch.as_tensor(H0), H1s=torch.as_tensor(np.stack([H1])))
    p0 = lift_unitary(torch.as_tensor(rx_rotation(1e-3).flatten()))
    pf = lift_unitary(torch.as_tensor(SX.flatten()))
    X_targ, _ = _targets(pf.numpy(), 1, n_steps, H)
    Q = np.eye(16, dtype=complex)
    return scenario_from_arrays(
        "not_gate", x0=p0.numpy(), A=A.numpy(), X_targ=X_targ,
        U_targ=np.full((1, n_steps + H), 0.5), Q=Q, R=np.eye(1) * 1e-2, Qf=10.0 * Q, sat=sat,
        du=du, target_state=pf.numpy(), exit_below=(pf.numpy(), 1e-2),
        config=MPCConfig(horizon=H, n_steps=n_steps, dt=dt, dim_u=1, order=order),
        plant=plant, device=device, dtype=dtype)


def lindblad_state(order: int = 2, detune: float = 0.99, gamma: float = 0.005, device="cuda",
                   dtype: Optional[torch.dtype] = None) -> Scenario:
    """The flagship's state preparation on a T1-limited open system (QP n = 10).

    The flagship's workload on an open system, amplitude damping L = sqrt(gamma) sigma_- in both the model (the
    order-k discretization of the Lindbladian drift) and the plant; dt = 1,
    H = 10, n_steps = 20, sat = 2 pi 0.1, du = 0.5 sat."""
    dt, H, n_steps = 1.0, 10, 20
    sat = 2 * np.pi * 0.1
    wq = 2 * np.pi * 4
    qubit = systems.RWAQubit(wQ=wq, wD=wq, wR=wq)
    c_ops = [np.sqrt(gamma) * np.array([[0.0, 1.0], [0.0, 0.0]], complex)]
    A = discretize_homogeneous([lindblad_generator(qubit.H_list[0], c_ops),
                                liouville_generator(qubit.H_list[1])], dt, order)
    plant_qubit = systems.RWAQubit(wQ=wq * detune, wD=wq, wR=wq)
    plant = LindbladPlant.create(plant_qubit.H_list[0], [plant_qubit.H_list[1]], c_ops=c_ops)
    Rx = rx_rotation(1e-4)
    rho0 = (Rx @ np.diag([1.0, 0.0]).astype(complex) @ Rx.conj().T).flatten()
    targ = np.diag([0.0, 1.0]).astype(complex).flatten()
    X_targ, U_targ = _targets(targ, 1, n_steps, H)
    Q = np.diag([1.0, 0, 0, 1]).astype(complex)
    return scenario_from_arrays(
        "lindblad_state", x0=rho0, A=A.numpy(), X_targ=X_targ, U_targ=U_targ, Q=Q,
        R=np.eye(1) * (1e-2 / sat ** 2), Qf=Q, sat=sat, du=0.5 * sat, target_state=targ,
        config=MPCConfig(horizon=H, n_steps=n_steps, dt=dt, dim_u=1, order=order),
        plant=plant, device=device, dtype=dtype)


def _quantum_plant(H_list, **settings) -> QuantumPlant:
    return QuantumPlant(H0=torch.as_tensor(H_list[0]), H1s=torch.as_tensor(np.stack(H_list[1:])),
                        sigma=torch.zeros((), dtype=torch.float64), **settings)


def _ground_pair(theta: float):
    """|0><0| of each qubit of a pair, rotated by Rx(-theta) and Rx(theta)."""
    ground = np.diag([1.0, 0.0]).astype(complex)
    return tuple(R @ ground @ R.conj().T for R in (rx_rotation(-theta), rx_rotation(theta)))


def crosstalk(order: int = 1, coupling: float = 0.0, device="cuda",
              dtype: Optional[torch.dtype] = None) -> Scenario:
    """Two qubits through per-qubit models on a plant with Z (x) Z crosstalk (QP n = 40).

    The crosstalk has strength `coupling`; partial-trace lift (model space
    dim 8, experiment space dim 16), measure_freq = 2, warm_start = False,
    dt = 0.5, H = 20, n_steps = 50, sat = 2 pi 0.1, du = 0.25. x0 and
    target_state are in experiment space, X_targ in model space.

    The reference's scenario assembles the block-diagonal model with
    qubit 2's control operator first while the plant's drive list has
    qubit 1 first, a swap of the control index between model and plant;
    here model control i is aligned with plant drive i.

    warm_start = False makes the QP budget the budget of every solve: one
    round of 150 iterations from rho0 = 1.0 (the condensed P has a diagonal
    near 1e-3 with a condition number near 1, and the default 0.1 mean-diag
    penalty under-weights the box) with 20 Newton-Schulz iterations.
    """
    dt, H, n_steps = 0.5, 20, 50
    sat = 2 * np.pi * 0.1
    qubits = systems.RWACrosstalk(coupling)
    basis2 = matrix_units(2)
    A1 = [vectorize_me(Hm, basis2).numpy() for Hm in qubits.H_list_1]
    A2 = [vectorize_me(Hm, basis2).numpy() for Hm in qubits.H_list_2]
    z = np.zeros((4, 4), dtype=complex)
    A_cts = [np.block([[A1[0], z], [z, A2[0]]]),
             np.block([[A1[1], z], [z, z]]),     # u1 drives qubit 1
             np.block([[z, z], [z, A2[1]]])]     # u2 drives qubit 2
    A = discretize_homogeneous(A_cts, dt, order)
    plant = _quantum_plant(qubits.H_list, lift_kind="partial_trace")
    rho1, rho2 = _ground_pair(1e-3)
    targ1 = np.diag([0.0, 1.0]).astype(complex)
    targ2 = np.diag([1.0, 0.0]).astype(complex)
    X_targ, U_targ = _targets(np.concatenate([targ1.flatten(), targ2.flatten()]), 2, n_steps, H)
    Q = np.kron(np.eye(2), np.diag([1.0, 0, 0, 1])).astype(complex)
    return scenario_from_arrays(
        "crosstalk", x0=np.kron(rho1, rho2).flatten(), A=A.numpy(), X_targ=X_targ,
        U_targ=U_targ, Q=Q, R=np.eye(2) * 1e-3, Qf=Q, sat=sat, du=0.25,
        target_state=np.kron(targ1, targ2).flatten(),
        config=MPCConfig(horizon=H, n_steps=n_steps, dt=dt, dim_u=2, order=order,
                         measure_freq=2, warm_start=False,
                         qp_params=BoxQPParams(rho0=1.0, max_iter=150, n_rounds=1,
                                               ns_iters=20)),
        plant=plant, device=device, dtype=dtype)


def cnot_state(order: int = 1, device="cuda", dtype: Optional[torch.dtype] = None) -> Scenario:
    """Entangling state preparation on an always-coupled pair (QP n = 150).

    The target is ramped, min(1, 2k / n_steps): dt = 0.25, H = 50, n_steps = 200,
    sat = 2 pi 0.05, du = sat; state dim 16, three controls (QP n = 150).

    The condensed QP is ill-conditioned and acceptance at the solver's
    default targets costs fidelity here, so the preset's own QP budget is
    three rounds of 300 iterations at eps 1e-8.
    """
    dt, H, n_steps = 0.25, 50, 200
    sat = 2 * np.pi * 0.05
    qubits = systems.RWACoupled()
    A = _model_operator(qubits.H_list, 4, dt, order)
    plant = _quantum_plant(qubits.H_list)
    rho0 = np.kron(*_ground_pair(1e-2))
    targ = np.kron(np.diag([1.0, 0.0]), np.diag([0.0, 1.0])).astype(complex).flatten()
    incline = np.array([min(1.0, 2 * k / n_steps) for k in range(n_steps + H + 1)])
    Qd = np.zeros(16)
    Qd[[0, 5, 10, 15]] = 1.0   # the four populations
    Q = np.diag(Qd).astype(complex)
    return scenario_from_arrays(
        "cnot_state", x0=rho0.flatten(), A=A.numpy(), X_targ=targ[:, None] * incline[None, :],
        U_targ=np.zeros((3, n_steps + H)), Q=Q, R=np.eye(3) * 1e-3, Qf=Q, sat=sat, du=sat,
        target_state=targ,
        config=MPCConfig(horizon=H, n_steps=n_steps, dt=dt, dim_u=3, order=order,
                         qp_params=BoxQPParams(eps_abs=1e-8, eps_rel=1e-8, max_iter=300,
                                               n_rounds=3)),
        plant=plant, device=device, dtype=dtype)


PRESETS = {"not_state": not_state, "not_state_freq": not_state_freq,
           "drag_state": drag_state, "crosstalk": crosstalk, "cnot_state": cnot_state,
           "not_gate": not_gate, "lindblad_state": lindblad_state}
