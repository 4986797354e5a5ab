"""Fleet runs through the fleet runner (counterpart of
mpc4quantum_tpu/benchfleet.py `run_hostloop_fleet`).

Take any Scenario, build a detuning-sweep lane batch, run it with the
preset's tuned budgets where the tables below have them (the scenario's
own budgets, cold, where they do not) and the caller's overrides, and
return the quality and throughput metrics; optionally re-run the marginal
lanes under an alternative scenario (the rescue pass) and keep each lane's
better result.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from .kernels.admm_big import admm_big
from .kernels.boxqp import boxqp_small
from .kernels.condense import condense_small
from .kernels.expm import expm_small
from .kernels.nsinv import ns_cold
from .mpc.fleet_runner import FleetRunner
from .ops.expm import taylor_budget
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
#       (freq's warm phase collapses at 16; moot under "gj"); without
#       ns_warm, ns_iters reaches the warm phase too;
#   rho0 - initial-penalty override of both phases (the carried dual and
#       rho that seed the steady solves come from warm solves at this rho0).
# A scenario with no entry has no tuned steady program: every solve runs
# the scenario's own QP budget, cold, at the solver's own acceptance. That
# is crosstalk, whose warm_start = False makes every step a warm step (its
# cut, rho0 1.0, 1x150, 20 Newton-Schulz iterations, lives in the preset),
# and any scenario outside the seven presets.
PRESET_STEADY_BUDGET = {
    "not_state": {"budget": (2, 10)},
    "not_gate": {"budget": (2, 10)},
    # 2x15: at 2x10 one chip lane in 256 failed acceptance in the JAX
    # package's sweep (the dissipative condensed P is slightly harder)
    "lindblad_state": {"budget": (2, 15)},
    "not_state_freq": {"budget": (1, 40), "scale": True, "ns_iters": 16, "ns_warm": 20},
    "drag_state": {"budget": (1, 19), "scale": True, "kinv": "gj"},
    # scale stays off: a scaled steady phase left the worst lane just above
    # the gate in the JAX package's sweep; 2x25 is the cliff
    "cnot_state": {"budget": (1, 80), "rho0": 1.0, "ns_iters": 20},
}
# per-warm-step SQP iterations: step 0 needs 7 line-searched iterations from
# the cold guess, step 1 converges in one; crosstalk, every step of which is
# a warm step, keeps 4 on every later step ((7, 2) costs 1e-3 of fidelity);
# a scenario outside the table runs DEFAULT_WARM_ITERS on every warm step
DEFAULT_WARM_ITERS = 8
PRESET_WARM_ITERS = {"not_state": (7, 1), "not_state_freq": (7, 1), "drag_state": (7, 1),
                     "not_gate": (7, 1), "lindblad_state": (7, 1), "cnot_state": (7, 1),
                     "crosstalk": (7, 4)}
# warm-phase budget of the large-n presets: (the preset's own default, the
# swept cut), applied only when the scenario kept its own budget
PRESET_WARM_BUDGET = {"not_state_freq": ((2, 150), (2, 40)),
                      "drag_state": ((2, 150), (2, 50)),
                      "cnot_state": ((3, 300), (3, 100))}
# warm-phase budget of the small problems (n <= 16) that leave qp_params at
# the library default: three rho rounds of 12 iterations under carried
# duals, of 15 for lindblad (its worst lane drops 1.7e-2 at 3x12 in the JAX
# package's sweep) and for every cold run (only that form is proven with
# cold steady solves)
SMALL_WARM_BUDGET = {"not_state": (3, 12), "not_gate": (3, 12), "lindblad_state": (3, 15)}
SMALL_COLD_BUDGET = (3, 15)
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
    return taylor_budget(plants.norm_bound(dt, sat))


def fleet_fidelity(sc: Scenario, final_x: torch.Tensor) -> np.ndarray:
    """Per-lane normalized overlap Re<target, x> / |target|^2 (float64 numpy)."""
    targ = sc.target_state.detach().cpu().to(torch.complex128).numpy()
    x = final_x.detach().cpu().to(torch.complex128).numpy()
    return np.real(x @ np.conj(targ)) / max(float(np.real(targ @ np.conj(targ))), 1e-12)


def warm_iters_for(sc: Scenario, warm_sqp_iters=None):
    """The warm steps' SQP iterations as the caller gives them, else as
    PRESET_WARM_ITERS has them, else DEFAULT_WARM_ITERS: an int for every
    warm step or a per-step tuple."""
    if warm_sqp_iters is None:
        return PRESET_WARM_ITERS.get(sc.name, DEFAULT_WARM_ITERS)
    return warm_sqp_iters


def make_runner(sc: Scenario, plants: Plant, expm_budget: str = "auto",
                kinv: Optional[str] = None, warm_kinv: Optional[bool] = None, *,
                warm_sqp_iters=None, warm_duals: Optional[bool] = None,
                steady_qp_params: Optional[BoxQPParams] = None, qp_kernel: str = "auto",
                lqr_seed: Optional[bool] = None) -> FleetRunner:
    """The fleet runner with the preset's tuned budgets and the caller's
    overrides, resolved as the reference's `run_hostloop_fleet` resolves
    them (mpc4quantum_tpu/benchfleet.py:243-380).

    :param kinv: None = the preset's tuned K-inverse (PRESET_STEADY_BUDGET
        "kinv", else the scenario's own); a BoxQPParams.kinv method forces
        it in both phases. Inert at n <= 16 (boxqp_small inverts itself).
    :param warm_kinv: None = the preset's default (no preset carries);
        True / False set config.qp_warm_kinv, the steady K-inverse carry
        (FleetRunner; the boxqp_big route only).
    :param warm_sqp_iters: SQP iterations of the warm steps, an int for
        every warm step or a per-step tuple; None = PRESET_WARM_ITERS, else
        DEFAULT_WARM_ITERS.
    :param warm_duals: None = carried duals where the preset has a tuned
        steady budget or `steady_qp_params` is given, cold otherwise;
        True / False force it. Forced, the preset's tuned steady budget,
        rho0 and Newton-Schulz cut are not applied; False also keeps the
        scenario's full warm budget (the tuned warm cuts were swept under
        carried duals).
    :param steady_qp_params: the steady phase's BoxQPParams, as given;
        None = the tuned steady budget, or the warm phase's.
    :param qp_kernel: "auto" (by n), "small" or "big" (FleetRunner);
        "big_unroll", the reference's unrolled-loop form of "big" on the
        TPU, runs as "big".
    :param lqr_seed: None = the scenario's config.lqr_seed; True / False
        set it.

    A streaming scenario (sc.config.streaming) keeps the warm SQP
    iterations but runs every QP cold at the scenario's own budget, as one
    `mpc()` lane does: the budgets were swept on a fixed model, and under
    per-lane refits the carried duals and the cut budgets fail lanes
    (not_state, 64 CPU lanes, float64, noiseless: 1 lane with the carried
    2x10 steady solves, 5 with cold 3x12 ones, none cold at the library's
    2x150). The JAX bench's forced-cold 3x15 keeps every lane noiseless but
    lower (min 0.99428 against 0.99652 at 2x150), and at sigma 1e-4 5 of
    its 64 lanes end on a QP failure, none at 2x150
    (tests/test_torch_learn.py::test_reference_loses_the_same_lanes), so
    it refuses warm_duals=True and steady_qp_params."""
    if sc.config.solver != "qp":
        raise ValueError("the fleets run the condensed box-QP kernels and cannot honor "
                         f"config.solver={sc.config.solver!r}; use mpc() or batched_mpc")
    qp_kernel = "big" if qp_kernel == "big_unroll" else qp_kernel
    warm_sqp_iters = warm_iters_for(sc, warm_sqp_iters)
    warm_iters = (tuple(warm_sqp_iters) if isinstance(warm_sqp_iters, (tuple, list))
                  else (warm_sqp_iters,))
    if sc.config.streaming and (warm_duals or steady_qp_params is not None):
        raise ValueError("a streaming fleet runs every QP cold: it takes no warm_duals=True "
                         "or steady_qp_params")
    preset = PRESET_STEADY_BUDGET.get(sc.name)
    tuned = None
    if warm_duals is None:
        warm_duals = preset is not None or steady_qp_params is not None
        tuned = preset if steady_qp_params is None else None
    taylor_k, max_sq = expm_budget_for(plants, sc.config.dt, sc.sat, expm_budget)
    kw = dict(du=sc.du, warm_sqp_iters=warm_iters, expm_taylor_k=taylor_k,
              expm_max_squarings=max_sq, exit_condition=sc.exit_condition,
              qp_kernel=qp_kernel)
    if kinv is None:
        kinv = (preset or {}).get("kinv")
    # the kernel route whatever the config's qp_backend (the reference's
    # HostLoopMPC with qp_impl="pallas")
    cfg = dataclasses.replace(sc.config, qp_backend="ns",
                              qp_warm_kinv=bool(warm_kinv) if warm_kinv is not None
                              else sc.config.qp_warm_kinv)
    if lqr_seed is not None:
        cfg = dataclasses.replace(cfg, lqr_seed=bool(lqr_seed))
    own = cfg.qp_params
    qp = own if kinv is None else dataclasses.replace(own, kinv=kinv)
    if steady_qp_params is not None and kinv is not None:
        steady_qp_params = dataclasses.replace(steady_qp_params, kinv=kinv)
    if cfg.streaming:
        return FleetRunner(dataclasses.replace(cfg, qp_params=qp), sc.sat,
                           steady_qp_params=None, carry_duals=False, **kw)
    if tuned is not None:
        qp = dataclasses.replace(qp, rho0=tuned.get("rho0", qp.rho0),
                                 ns_iters=tuned.get("ns_warm", tuned.get("ns_iters", qp.ns_iters)))
    warm_budget = PRESET_WARM_BUDGET.get(sc.name) if warm_duals else None
    if warm_budget is not None and (qp.n_rounds, qp.max_iter) == warm_budget[0]:
        qp = dataclasses.replace(qp, n_rounds=warm_budget[1][0], max_iter=warm_budget[1][1])
    if cfg.horizon * cfg.dim_u <= 16 and (qp.n_rounds, qp.max_iter) == (
            BoxQPParams.n_rounds, BoxQPParams.max_iter):
        rounds, iters = (SMALL_WARM_BUDGET.get(sc.name, (3, 12)) if warm_duals
                         else SMALL_COLD_BUDGET)
        qp = dataclasses.replace(qp, n_rounds=rounds, max_iter=iters)
    cfg = dataclasses.replace(cfg, qp_params=qp)
    steady = steady_qp_params
    if tuned is not None:
        rounds, iters = tuned["budget"]
        steady = dataclasses.replace(qp, n_rounds=rounds, max_iter=iters,
                                     accept_abs=STEADY_ACCEPT, accept_rel=STEADY_ACCEPT,
                                     ns_iters=tuned.get("ns_iters", own.ns_iters),
                                     scale=tuned.get("scale", False) or own.scale)
    return FleetRunner(cfg, sc.sat, steady_qp_params=steady, carry_duals=warm_duals, **kw)


def rescue_pass(sc: Scenario, rescue: dict, plants: Plant, out: dict, fid: np.ndarray,
                expm_budget: str, **runner_kw) -> dict:
    """Re-run the marginal lanes of a finished fleet under an alternative
    scenario and keep each lane's better result, in place in `out` and
    `fid`.

    Marginal lanes - fidelity below rescue["threshold"] (default 0.99) or
    not completed - are gathered, padded to a power of two by repeating the
    first of them (few distinct batch shapes), and run under
    rescue["scenario"] (default `sc`) on the same plants with the same
    `expm_budget` and `runner_kw` (make_runner's keyword options;
    warm_sqp_iters only where the alternative scenario has `sc`'s name, as
    the reference passes it). A lane takes the re-run's state and exit code
    where that run completed with a higher fidelity.

    :return: the rescue's metrics: rescued_lanes, rescue_improved,
        rescue_batch, rescue_s and rescue_launches (the kernel launches of
        this pass alone, by wrapper); empty when no lane was marginal.
    """
    thr = float(rescue.get("threshold", 0.99))
    sc_alt = rescue.get("scenario", sc)
    if sc_alt.name != sc.name:
        runner_kw = {**runner_kw, "warm_sqp_iters": None}
    codes = out["exit_code"].cpu().numpy()
    marginal = (fid < thr) | ~((codes == 0) | (codes == 1))
    if not marginal.any():
        return {}
    t0 = time.perf_counter()
    counters = {"boxqp_small": boxqp_small, "expm_small": expm_small, "admm_big": admm_big,
                "condense_small": condense_small, "ns_cold": ns_cold}
    before = {k: fn.launches for k, fn in counters.items()}
    idx = np.nonzero(marginal)[0]
    n = len(idx)
    pad = 1 << (n - 1).bit_length()
    on_device = lambda a: torch.as_tensor(a, device=plants.device)
    idx_p = on_device(np.concatenate([idx, np.repeat(idx[:1], pad - n)]))
    _, out_r = run_hostloop_fleet(sc_alt, pad, plants=plants[idx_p], expm_budget=expm_budget,
                                  **runner_kw)
    fid_r = fleet_fidelity(sc_alt, out_r["final_x"])[:n]
    codes_r = out_r["exit_code"].cpu().numpy()[:n]
    better = (fid_r > fid[idx]) & ((codes_r == 0) | (codes_r == 1))
    take, keep = on_device(idx[better]), on_device(better)
    out["final_x"][take] = out_r["final_x"][:n][keep].to(out["final_x"].dtype)
    out["exit_code"][take] = out_r["exit_code"][:n][keep]
    fid[idx[better]] = fid_r[better]
    return {"rescued_lanes": int(len(idx)), "rescue_improved": int(better.sum()),
            "rescue_batch": int(pad), "rescue_s": round(time.perf_counter() - t0, 3),
            "rescue_launches": {k: fn.launches - before[k] for k, fn in counters.items()}}


def run_hostloop_fleet(sc: Scenario, batch: int, plants: Optional[Plant] = None,
                       seed: int = 1, detune_scale: float = 0.01, reps: int = 1,
                       expm_budget: str = "auto", kinv: Optional[str] = None,
                       warm_kinv: Optional[bool] = None, warm_sqp_iters=None,
                       warm_duals: Optional[bool] = None,
                       steady_qp_params: Optional[BoxQPParams] = None, qp_kernel: str = "auto",
                       lqr_seed: Optional[bool] = None, rescue: Optional[dict] = None,
                       record: bool = False, noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       model_update_fn: Optional[Callable] = None,
                       observe_fn: Optional[Callable] = None,
                       checkpoint_path: Optional[str] = None, checkpoint_every: int = 0,
                       progress_every: int = 0):
    """Run a `batch`-lane detuning-sweep fleet of any scenario `sc` on the
    scenario's device.

    :param plants: an explicit lane batch (e.g. JAX-drawn plants through
        convert.scenario_from_numpy); None = make_scenario_batch from a CPU
        generator seeded with `seed`.
    :param reps: total runs; the first pays one-time costs (the kernel
        build) and is reported as first_run_s, the rate uses the best of
        the others (of the first when reps = 1).
    :param kinv, warm_kinv: the K-inverse of both phases and the steady
        K-inverse carry (`make_runner`); None = the preset's defaults. The
        metrics report the resolved "kinv" (the steady phase's), "warm_kinv"
        (config.qp_warm_kinv) and, on the last run, the carry's
        "kinv_warm_solves" and "kinv_guard_cold" (lanes whose carried
        inverse failed the guard and restarted cold; both 0 without the
        carry, which runs only on the boxqp_big route).
    :param warm_sqp_iters, warm_duals, steady_qp_params, qp_kernel, lqr_seed:
        the reference's overrides (`make_runner`): the warm steps' SQP
        iterations (an int or a per-step tuple), carried duals, the steady
        phase's budget, the QP kernel ("auto" / "small" / "big";
        "big_unroll" runs as "big") and the LQR-seeded initial guess. The
        reference's `granularity`, `steady_fuse`, `qp_impl` and
        `plant_impl` choose TPU dispatch forms and have no counterpart.
    :param rescue: None, or {"threshold": fid, "scenario": Scenario} of a
        per-lane rescue pass (`rescue_pass`) after the last run. Rates and
        times stay the main pass's; the rescue's cost is rescue_s.
    :param record, noise, generator, model_update_fn, observe_fn: passed
        to `FleetRunner.run` (the per-step record; measurement noise as a
        (n_steps, batch, n_obs) tensor or drawn by the generator each run;
        the per-lane streaming refit of sc.model under
        sc.config.streaming; the observation).
    :param checkpoint_path, checkpoint_every, progress_every: the first
        run's checkpoint / resume and heartbeat (`FleetRunner.run`); the
        timing repetitions run the whole loop without them. With a
        checkpoint path the metrics carry checkpoint_s, the seconds of each
        checkpoint written.
    :return: (metrics dict, the last run's output: "final_x", "exit_code",
        "model_state", and the record's keys with `record`).
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
    runner_kw = dict(kinv=kinv, warm_kinv=warm_kinv, warm_sqp_iters=warm_sqp_iters,
                     warm_duals=warm_duals, steady_qp_params=steady_qp_params,
                     qp_kernel=qp_kernel, lqr_seed=lqr_seed)
    runner = make_runner(sc, plants, expm_budget, **runner_kw)
    args = (sc.x0, sc.model, plants, sc.X_targ, sc.U_targ, sc.Q, sc.R, sc.Qf)
    run_kw = dict(record=record, noise=noise, generator=generator,
                  model_update_fn=model_update_fn, observe_fn=observe_fn)

    def timed(**first_only):
        t0 = time.perf_counter()
        out = runner.run(*args, **run_kw, **first_only)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out, time.perf_counter() - t0

    out, first_s = timed(checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
                         progress_every=progress_every)
    checkpoint_s = list(runner.checkpoint_seconds)
    rep_s = []
    for _ in range(max(reps - 1, 0)):
        out, t = timed()
        rep_s.append(t)
    best = min(rep_s) if rep_s else first_s
    warm_iters = warm_iters_for(sc, warm_sqp_iters)
    fid = fleet_fidelity(sc, out["final_x"])
    rescue_info = {} if rescue is None else rescue_pass(sc, rescue, plants, out, fid,
                                                        expm_budget, **runner_kw)
    codes = out["exit_code"].cpu().numpy()
    kinv_counts = ([0, 0] if runner.kinv_counts is None
                   else [int(c) for c in runner.kinv_counts.cpu()])
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
        # the reference's keys: where the QP and the plant step run (the
        # wrappers run their plain versions on a CPU tensor), the carried
        # duals, the LQR seed and the K-inverse carry
        "qp_impl": "cuda" if device.type == "cuda" else "plain",
        "plant_impl": "cuda" if device.type == "cuda" else "plain",
        "warm_duals": runner.carry_duals and runner.config.warm_start,
        "lqr_seed": bool(runner.config.lqr_seed),
        "warm_kinv": bool(runner.config.qp_warm_kinv),
        "kinv": steady.kinv,
        "kinv_warm_solves": kinv_counts[0],
        "kinv_guard_cold": kinv_counts[1],
        # as the caller or the table gave it: an int, or a per-step list
        "warm_sqp_iters": (list(warm_iters) if isinstance(warm_iters, (tuple, list))
                           else int(warm_iters)),
        "expm_budget": [runner.expm_taylor_k, runner.expm_max_squarings],
        **rescue_info,
    }
    if checkpoint_path:
        metrics["checkpoint_s"] = checkpoint_s
    return metrics, out
