"""PyTorch/CUDA port of mpc4quantum_tpu for NVIDIA Hopper.

Model predictive control of quantum state preparation, batched over fleets
of perturbed plants. The modules mirror the JAX package (`ops/`,
`solvers/`, `plants/`, `models/`, `mpc/`, `parallel/`, `presets.py`,
`benchfleet.py`); the box-QP solve and the plant expm run as hand-written
CUDA kernels (`kernels/`, sources in `csrc/`) on the card and as their plain
PyTorch versions on the CPU. This package never imports JAX.

Quick start, on the card (float32):

    from mpc4quantum_tpu_torch import presets, run_hostloop_fleet
    sc = presets.not_state()
    metrics, out = run_hostloop_fleet(sc, batch=16384, reps=4)

On the CPU, through the kernels' plain versions: presets.not_state(device="cpu")
(float64 there). The seven presets are in presets.PRESETS; `rescue=` of
run_hostloop_fleet re-runs the marginal lanes under a second scenario.

The learned-model loop: `mpc()` runs one rollout (a one-lane fleet) and
returns an MPCResult; a model from models.dmdc (OnlineDMDc, DiscrepDMDc,
HistoryState) with config.streaming and `model_update_fn` refits online,
per lane in a fleet; `train_model` fits a DiscrepDMDc from data made by
`quantum_simulate`; measurement noise is a tensor or a torch.Generator's.

Single rollouts and lane batches: `mpc()` and `batched_mpc` solve each step
by config.qp_backend ("chol", the adaptive Cholesky ADMM `solve_boxqp`, by
default; "ns" the kernels) or the clipped LQR (config.solver="lqr"); the
fleet runner checkpoints and resumes (`checkpoint_path=`). The CLI is
`python -m mpc4quantum_tpu_torch <preset>` (`--cpu` for the CPU).

The K-inverse of the large-n route: BoxQPParams.kinv "riccati" /
"riccati_pscan" (solvers/riccati.py) and the steady carry
MPCConfig.qp_warm_kinv; run_hostloop_fleet(kinv=, warm_kinv=) forces them.
Real states: the classical plants (VanDerPol, Rotor, rk4_simulate) run
`mpc()` on a real Koopman model, and mpc/embedded.py runs a quantum problem
in its real embedding.

Several processes (parallel/): `init_distributed` joins a torch.distributed
group (NCCL on the card, gloo on the CPU), `sharded_mpc` shards a lane
batch over the ranks of a mesh (`scenario_mesh`) and gathers the result,
`sharded_fleet_summary` reduces across ranks, `scaling_report` measures
weak scaling; parallel/tensor.py splits the model operator's rows over an
"op" axis (`tp_model_fns`, passed as mpc(model_fns=), batched_mpc and
sharded_mpc take it too: the driver's seam `ModelApplyFns`).

The reference's single-call functions are here under their names: the Pade
`expm_pade`, `propagators_from_controls`, the one-point bilinear forms
(ops/bilinear.py), the plants' free step, lift and simulate functions, and
utils/plotting.py (matplotlib, imported when called).
"""

from . import presets
from .benchfleet import rescue_pass, run_hostloop_fleet
from .models.dmdc import (DiscrepDMDc, DMDcModel, HistoryState, OnlineDMDc, discrep_append,
                          discrep_bootstrap, discrep_fit_iteration, discrep_from_data,
                          discrep_from_randn, dmdc_from_operator, history_p_snapshots,
                          history_snapshots, history_update, online_fit_iteration,
                          online_from_bootstrap, online_from_data, online_from_randn, predict,
                          with_history)
from .models.training import prediction_loss, train_model
from .mpc.clock import StepClock, val_to_str
from .mpc.driver import ModelApplyFns, MPCConfig, MPCResult, lqr_seed_guess, trim
from .mpc.fleet_runner import batched_mpc, mpc
from .ops.bilinear import BilinearModel, model_along_traj, model_from_initial
from .ops.expm import expm_pade, propagators_from_controls
from .parallel.fleet import (fleet_summary, make_scenario_batch, scenario_mesh, sharded_fleet_summary,
                             sharded_mpc)
from .parallel.mesh import fleet_mesh, init_distributed, scaling_report
from .plants.classical import ClassicalPlant, Rotor, VanDerPol, rk4_simulate
from .plants.lindblad import LindbladPlant, lindblad_simulate, lindblad_step, lindblad_step_taylor
from .plants.quantum import (LiftKind, QuantumPlant, lift_state, proj_state, quantum_expectations,
                             quantum_observe, quantum_simulate, quantum_step, quantum_step_taylor)
from .plants.synthesis import SynthesisPlant, lift_unitary, proj_process, synthesis_simulate
from .solvers.boxqp import BoxQPParams, solve_boxqp
from .solvers.condense import condense_horizon, quad_program
from .solvers.lqr import lqr_quad_program

__all__ = [
    "presets", "rescue_pass", "run_hostloop_fleet",
    "DiscrepDMDc", "DMDcModel", "HistoryState", "OnlineDMDc", "discrep_append",
    "discrep_bootstrap", "discrep_fit_iteration", "discrep_from_data", "discrep_from_randn",
    "dmdc_from_operator", "history_p_snapshots", "history_snapshots", "history_update",
    "online_fit_iteration", "online_from_bootstrap", "online_from_data", "online_from_randn",
    "predict", "with_history", "prediction_loss", "train_model", "StepClock", "val_to_str",
    "ModelApplyFns", "MPCConfig", "MPCResult", "lqr_seed_guess", "mpc", "trim", "batched_mpc",
    "BilinearModel", "model_along_traj", "model_from_initial", "expm_pade",
    "propagators_from_controls", "fleet_summary", "make_scenario_batch", "scenario_mesh",
    "sharded_fleet_summary", "sharded_mpc", "fleet_mesh", "init_distributed", "scaling_report",
    "ClassicalPlant", "Rotor", "VanDerPol", "rk4_simulate", "LindbladPlant", "lindblad_simulate",
    "lindblad_step", "lindblad_step_taylor", "LiftKind", "QuantumPlant", "lift_state",
    "proj_state", "quantum_expectations", "quantum_observe", "quantum_simulate", "quantum_step",
    "quantum_step_taylor", "SynthesisPlant", "lift_unitary", "proj_process",
    "synthesis_simulate", "BoxQPParams", "solve_boxqp", "condense_horizon",
    "quad_program", "lqr_quad_program",
]
