"""Preset fleet runs through the fleet runner (counterpart of
mpc4quantum_tpu/benchfleet.py `run_hostloop_fleet`, for the ported presets:
`not_state`, `not_state_freq`, `drag_state`, `not_gate`, `lindblad_state`).

Take a Scenario, build a detuning-sweep lane batch, run it with the
preset's tuned budgets and return the quality and throughput metrics.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from .mpc.fleet_runner import FleetRunner
from .parallel.fleet import make_scenario_batch
from .plants.base import Plant
from .presets import Scenario
from .solvers.boxqp import BoxQPParams

# The JAX package's swept production settings, per preset. Steady-phase QP
# under dual warm starting, acceptance 4e-3:
#   budget (n_rounds, max_iter) - 2x6 collapses the flagship; the large-n
#       presets run one round (rho is frozen on acceptance in the steady
#       chain, so a second round recomputed the same inverse);
#   scale - Jacobi-equilibrate the steady phase only (y crosses the seam
#       unscaled, rho in the solver's space);
#   kinv - K-inverse of both phases ("gj" exact; else the library's "ns");
#   ns_iters / ns_warm - Newton-Schulz budget of the steady / warm phase
#       (freq's warm phase collapses at 16; moot under "gj").
PRESET_STEADY_BUDGET = {
    "not_state": {"budget": (2, 10)},
    "not_gate": {"budget": (2, 10)},
    # 2x15: at 2x10 one chip lane in 256 failed acceptance in the JAX
    # package's sweep (the dissipative condensed P is slightly harder)
    "lindblad_state": {"budget": (2, 15)},
    "not_state_freq": {"budget": (1, 40), "scale": True, "ns_iters": 16, "ns_warm": 20},
    "drag_state": {"budget": (1, 19), "scale": True, "kinv": "gj"},
}
# per-warm-step SQP iterations: step 0 needs 7 line-searched iterations from
# the cold guess, step 1 converges in one
PRESET_WARM_ITERS = {"not_state": (7, 1), "not_state_freq": (7, 1), "drag_state": (7, 1),
                     "not_gate": (7, 1), "lindblad_state": (7, 1)}
# warm-phase budget of the large-n presets: (the preset's own default, the
# swept cut), applied only when the scenario kept its own budget
PRESET_WARM_BUDGET = {"not_state_freq": ((2, 150), (2, 40)),
                      "drag_state": ((2, 150), (2, 50))}
# warm-phase budget of the small presets (n <= 16) that leave qp_params at
# the library default: three rho rounds of 12 iterations, of 15 for
# lindblad (its worst lane drops 1.7e-2 at 3x12 in the JAX package's sweep)
SMALL_WARM_BUDGET = {"not_state": (3, 12), "not_gate": (3, 12), "lindblad_state": (3, 15)}
STEADY_ACCEPT = 4e-3
# expm budgets: "auto" sizes squarings from a norm bound with Taylor degree
# 12 (exact to ~9e-12 at a scaled norm <= 0.8); "any_norm" is (18, 12)
EXPM_BUDGETS = ("auto", "any_norm")


def expm_budget_for(plants: Plant, dt: float, sat, budget: str = "auto"):
    """(taylor_k, max_squarings) of the plant expm.

    "auto": squarings s such that the worst-case scaled norm of the step's
    generator (dt H(u), or dt A(u) on an open system)
    ||.||_1 * 1.3 / 2^s <= 0.8 over every lane and the control box,
    where 1.3 is a safety margin on the bound, which already includes each
    lane's detuning; at s = 0 the expm skips its norm, scaling and squaring.
    """
    if budget == "any_norm":
        return 18, 12
    if budget != "auto":
        raise ValueError(f"expm_budget={budget!r} is not one of {EXPM_BUDGETS}")
    bound = plants.norm_bound(dt, sat)
    squarings = max(0, int(math.ceil(math.log2(max(bound, 1e-12) * 1.3 / 0.8))))
    # the form certifies itself: the scaled norm is within Taylor 12's range
    assert bound * 2.0 ** -squarings <= 0.8, (bound, squarings)
    return 12, squarings


def fleet_fidelity(sc: Scenario, final_x: torch.Tensor) -> np.ndarray:
    """Per-lane normalized overlap Re<target, x> / |target|^2 (float64 numpy)."""
    targ = sc.target_state.detach().cpu().to(torch.complex128).numpy()
    x = final_x.detach().cpu().to(torch.complex128).numpy()
    return np.real(x @ np.conj(targ)) / max(float(np.real(targ @ np.conj(targ))), 1e-12)


def make_runner(sc: Scenario, plants: Plant, expm_budget: str = "auto") -> FleetRunner:
    """The fleet runner with the preset's tuned budgets."""
    if sc.name not in PRESET_WARM_ITERS:
        raise NotImplementedError(f"preset {sc.name!r} is not ported")
    tuned = PRESET_STEADY_BUDGET[sc.name]
    own = sc.config.qp_params
    qp = own
    warm_budget = PRESET_WARM_BUDGET.get(sc.name)
    if warm_budget is not None and (qp.n_rounds, qp.max_iter) == warm_budget[0]:
        qp = dataclasses.replace(qp, n_rounds=warm_budget[1][0], max_iter=warm_budget[1][1])
    cfg = sc.config
    if cfg.horizon * cfg.dim_u <= 16 and (qp.n_rounds, qp.max_iter) == (
            BoxQPParams.n_rounds, BoxQPParams.max_iter):
        rounds, iters = SMALL_WARM_BUDGET[sc.name]
        qp = dataclasses.replace(qp, n_rounds=rounds, max_iter=iters)
    qp = dataclasses.replace(qp, kinv=tuned.get("kinv", qp.kinv),
                             ns_iters=tuned.get("ns_warm", tuned.get("ns_iters", qp.ns_iters)))
    cfg = dataclasses.replace(cfg, qp_params=qp)
    rounds, iters = tuned["budget"]
    steady = dataclasses.replace(qp, n_rounds=rounds, max_iter=iters,
                                 accept_abs=STEADY_ACCEPT, accept_rel=STEADY_ACCEPT,
                                 ns_iters=tuned.get("ns_iters", own.ns_iters),
                                 scale=tuned.get("scale", False) or own.scale)
    taylor_k, max_sq = expm_budget_for(plants, cfg.dt, sc.sat, expm_budget)
    return FleetRunner(cfg, sc.sat, du=sc.du, warm_sqp_iters=PRESET_WARM_ITERS[sc.name],
                       steady_qp_params=steady, expm_taylor_k=taylor_k,
                       expm_max_squarings=max_sq, exit_condition=sc.exit_condition)


def run_hostloop_fleet(sc: Scenario, batch: int, plants: Optional[Plant] = None,
                       seed: int = 1, detune_scale: float = 0.01, reps: int = 1,
                       expm_budget: str = "auto"):
    """Run a `batch`-lane detuning-sweep fleet of `sc` on the scenario's device.

    :param plants: an explicit lane batch (e.g. JAX-drawn plants through
        convert.scenario_from_numpy); None = make_scenario_batch from a CPU
        generator seeded with `seed`.
    :param reps: total runs; the first pays one-time costs (the kernel
        build) and is reported as first_run_s, the rate uses the best of
        the others (of the first when reps = 1).
    :return: (metrics dict, {"final_x", "exit_code"} of the last run).
    """
    device = sc.x0.device
    dtype = sc.plant.real_dtype
    if plants is None:
        plants = make_scenario_batch(sc.plant, batch, detune_scale=detune_scale,
                                     generator=torch.Generator().manual_seed(seed),
                                     device=device, dtype=dtype)
    if plants.lanes != batch:
        raise ValueError(f"plant batch has {plants.lanes} lanes, expected {batch}")
    if device.type == "cuda":
        # the complex condensed products need full f32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    runner = make_runner(sc, plants, expm_budget)
    args = (sc.x0, sc.model, plants, sc.X_targ, sc.U_targ, sc.Q, sc.R, sc.Qf)

    def timed():
        t0 = time.perf_counter()
        out = runner.run(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out, time.perf_counter() - t0

    out, first_s = timed()
    rep_s = []
    for _ in range(max(reps - 1, 0)):
        out, t = timed()
        rep_s.append(t)
    best = min(rep_s) if rep_s else first_s
    fid = fleet_fidelity(sc, out["final_x"])
    codes = out["exit_code"].cpu().numpy()
    steady = runner.steady_qp_params
    warm = runner.config.qp_params
    metrics = {
        "preset": sc.name,
        "batch": batch,
        "device": str(device),
        "dtype": str(dtype).replace("torch.", ""),
        "rollouts_per_s": batch / best,
        "rollouts_per_s_median": batch / float(np.median(rep_s)) if rep_s else batch / best,
        "timed_reps": len(rep_s),
        "first_run_s": first_s,
        "fidelity_mean": round(float(fid.mean()), 5),
        "fidelity_min": round(float(fid.min()), 5),
        "completed_frac": round(float(((codes == 0) | (codes == 1)).mean()), 4),
        "exit_early_frac": round(float((codes == 1).mean()), 4),
        "qp_fail_frac": round(float((codes == 2).mean()), 4),
        "steady_budget": f"{steady.n_rounds}x{steady.max_iter}",
        "warm_budget": f"{warm.n_rounds}x{warm.max_iter}",
        "qp_scale": steady.scale,
        "qp_kernel": runner.qp_kernel,
        "warm_sqp_iters": list(runner.warm_sqp_iters),
        "expm_budget": [runner.expm_taylor_k, runner.expm_max_squarings],
    }
    return metrics, out
