"""Receding-horizon MPC step pieces (counterpart of mpc4quantum_tpu/mpc/driver.py),
batched over lanes: the per-step context, the SQP state, the line search,
the QP-result update and the advance.

Reference behaviour kept on purpose:
  - the tracking window for step s starts at column max(s-1, 0): the
    reference shifts its window at the end of the previous step;
  - the first-step slew box is anchored at the benchmark control on steps
    0 and 1 and at the last applied control afterwards;
  - the QP dual carried to the next step drops the applied step's block and
    duplicates the last one (the receding-horizon shift of the guesses);
  - lanes that are done keep their state, guesses and duals frozen;
  - exit codes are data: 0 completed, 1 the scenario's exit condition met,
    2 QP failure, 3 non-finite objective; the exit condition reads the
    current state, not the next one (the reference's not_gate condition
    reads its second argument), so it fires one step after the threshold
    is crossed;
  - the loop runs every step whatever the lanes' state: a lane that is done
    stays frozen (the reference host loop has no early break);
  - at a measurement step the observation (noisy where the plant has a
    sigma) re-seeds the loop and the true plant state alike; between
    measurements the loop closes through the model and the plant runs on;
  - the streaming refit sees (lift(x_next), lift(x_cur), f(u) (kr) lift(x_cur))
    and is held on lanes that are done or whose step failed.

The fleet runner (mpc/fleet_runner.py) drives these pieces; `mpc()` and
`batched_mpc` live there. `trim` cuts a rollout's record to the executed
steps. `lqr_seed_guess` is the LQR-seeded initial guess of
config.lqr_seed. `ModelApplyFns` is the seam through which a caller
replaces the two stacked-operator contractions of a step (the
linearization and the model prediction), e.g. by the row-sharded forms of
parallel/tensor.py; None is the dense path.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from ..models.dmdc import predict, tree_where
from ..ops.library import krtimes
from ..ops.bilinear import BilinearModel, model_along_traj
from ..plants.base import Plant
from ..solvers.boxqp import BoxQPParams
from ..solvers.condense import QPResult, objective_value
from ..solvers.lqr import lqr_quad_program


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    """Static configuration of the MPC loop."""

    horizon: int
    n_steps: int
    dt: float
    dim_u: int
    order: int
    measure_freq: int = 1
    # line-searched SQP iterations a warm step may take in `mpc()`
    max_iter: int = 100
    warm_start: bool = True
    # refit the model online with the runner's model_update_fn
    streaming: bool = False
    step_tol: float = 1e-4
    qp_params: BoxQPParams = dataclasses.field(default_factory=BoxQPParams)
    # "qp": the condensed box QP; "lqr": the clipped affine-tracking LQR
    # (no slew box, no iterative solver) - `mpc()` and `batched_mpc` only
    solver: str = "qp"
    # box-QP solver of `mpc()` and `batched_mpc`: "chol" the adaptive
    # Cholesky ADMM, "ns" the fixed-budget kernel route; the fleets of
    # benchfleet run the kernels whatever it says
    qp_backend: str = "chol"
    # seed each steady (single-shot) QP from the previous solve's shifted
    # dual and rho; off: every QP starts cold, as the reference's default
    qp_warm_duals: bool = False
    # start from the clipped LQR rollout of the step-0 linearization
    # (`lqr_seed_guess`) instead of repeat(lift(x0)) and zero controls
    lqr_seed: bool = False
    # carry each steady solve's K-inverse into the next one's Newton-Schulz
    # refresh (the preset fleets' runner, the boxqp_big route only; mpc()
    # and batched_mpc ignore it, as the reference's mpc() does)
    qp_warm_kinv: bool = False


class ModelApplyFns(NamedTuple):
    """Replacements for the stacked-operator contractions of an MPC step,
    batched over lanes (the seam for tensor-parallel execution; the QP,
    the plant and the costs stay the runner's own code).

    linearize: (model_A (dim_x, dim_z) shared or (B, dim_x, dim_z) per
        lane, X (B, dim_x, H), U (B, dim_u, H)) -> (A_s (B, H, dim_x,
        dim_x), B_s (B, H, dim_x, dim_u), Delta_s (B, H, dim_x)), as
        ops.bilinear.model_along_traj.
    predict: (model_A, lift_x (B, dim_x), ux (B, Lm dim_x)) -> (B, dim_x),
        the model's next state, as models.dmdc.predict.
    lift_u: (dim_u, ...) -> (Lm, ...) the non-constant monomial lift.
    """

    linearize: Callable
    predict: Callable
    lift_u: Callable


class Carry(NamedTuple):
    """Per-lane loop state between MPC steps (leading axis B)."""

    x_cur: torch.Tensor      # (B, dim_e) observed state
    x_true: torch.Tensor     # (B, dim_e) true plant state
    X_guess: torch.Tensor    # (B, dim_x, H+1) complex
    U_guess: torch.Tensor    # (B, dim_u, H)
    u_last: torch.Tensor     # (B, dim_u) last applied control
    exit_code: torch.Tensor  # (B,) int32
    done: torch.Tensor       # (B,) bool


class SQPState(NamedTuple):
    """Per-lane SQP iterate within one MPC step (leading axis B)."""

    Xg: torch.Tensor
    Ug: torch.Tensor
    X_opt: torch.Tensor
    U_opt: torch.Tensor
    obj: torch.Tensor
    n_iter: torch.Tensor
    done: torch.Tensor
    code: torch.Tensor
    y: torch.Tensor          # (B, H*dim_u) QP dual carrier
    rho: torch.Tensor        # (B,) QP penalty carrier (0 = cold sentinel)


class StepContext(NamedTuple):
    X_ref: torch.Tensor      # (dim_x, H+1)
    U_ref: torch.Tensor      # (dim_u, H)
    lift_x: torch.Tensor     # (B, dim_x)
    u_prev: torch.Tensor     # (B, dim_u)


def _lane(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a (B,) mask against a (B, ...) tensor."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - 1))


def select(mask, old, new):
    """Per lane: `old` where mask, else `new` (fields of two NamedTuples)."""
    return type(old)(*(torch.where(_lane(mask, a), a, b) for a, b in zip(old, new)))


class MPCResult(NamedTuple):
    """One rollout's record (the reference's `mpc` contract)."""

    xs: torch.Tensor         # (dim_e, n_steps + 1) observed states, x0 first
    us: torch.Tensor         # (dim_u, n_steps) applied controls (0 where none)
    exit_code: torch.Tensor  # () int32: 0 ok, 1 exit condition, 2 QP fail, 3 non-finite obj
    n_valid: torch.Tensor    # () number of steps whose control was applied
    objs: torch.Tensor       # (n_steps,) the step's QP objective (0 once done)
    sqp_iters: torch.Tensor  # (n_steps,) SQP iterations of the step (0 once done)
    model_A: torch.Tensor    # the final (refit) stacked operator
    model_state: object      # the final model


def trim(result: MPCResult):
    """(xs, us) as numpy, cut to the executed steps: a code-1 exit drops the
    state and the control of the step that triggered it (the reference's
    early-exit slicing); codes 0, 2 and 3 keep every applied control. A
    code-1 exit at step 0 gives the empty (dim_u, 0) controls."""
    n = int(result.n_valid)
    code = int(result.exit_code)
    xs = result.xs.detach().cpu().numpy()
    us = result.us.detach().cpu().numpy()
    if code == 1:
        return xs[:, :n], us[:, : max(n - 1, 0)]
    return xs[:, : n + 1], us[:, :n]


def bilinear_model(model, config: MPCConfig) -> BilinearModel:
    """The bilinear view of a model's stacked operator; a lane batch of
    models (A of shape (B, dim_x, dim_z)) gives per-lane operators."""
    dim_x = model.A.shape[-2]
    return BilinearModel.from_stacked(model.A[..., :dim_x], model.A[..., dim_x:],
                                      config.dim_u, config.order)


def window(step: int, config: MPCConfig, X_targ, U_targ):
    """Step `step`'s tracking window: (X_ref (dim_x, H + 1), U_ref (dim_u,
    H)) from column max(step - 1, 0)."""
    H = config.horizon
    start = max(step - 1, 0)
    return X_targ[:, start:start + H + 1], U_targ[:, start:start + H]


def slew_anchor(step: int, U_ref, u_last):
    """The control the first-step slew box is anchored at: the window's
    benchmark control on steps 0 and 1, the last applied one after."""
    return u_last if step > 1 else U_ref[:, 0].expand_as(u_last)


def context(carry: Carry, step: int, config: MPCConfig, X_targ, U_targ,
            plants: Plant) -> StepContext:
    """Per-step quantities shared by the SQP iterations and the advance."""
    X_ref, U_ref = window(step, config, X_targ, U_targ)
    return StepContext(X_ref, U_ref, plants.lift(carry.x_cur),
                       slew_anchor(step, U_ref, carry.u_last))


def sqp_init(carry: Carry, duals) -> SQPState:
    """Initial SQP state; `duals` = (y (B, H*dim_u), rho (B,)) carried from
    the previous step (zeros = cold)."""
    B = carry.X_guess.shape[0]
    dev = carry.X_guess.device
    rdtype = carry.U_guess.dtype
    return SQPState(carry.X_guess, carry.U_guess, carry.X_guess, carry.U_guess,
                    torch.full((B,), float("inf"), dtype=rdtype, device=dev),
                    torch.zeros(B, dtype=torch.int32, device=dev),
                    torch.zeros(B, dtype=torch.bool, device=dev),
                    torch.zeros(B, dtype=torch.int32, device=dev),
                    duals[0], duals[1])


def _line_search_alpha(Q_s, R_s, X_ref, U_ref, X_guess, U_guess, X_opt, U_opt, step_tol):
    """Exact line search along (opt - guess) on the quadratic tracking cost:
    three evaluations fix the parabola, alpha = -b/(2a) clamped to [0, 1].

    Evaluated in float64 whatever the working dtype: the fit subtracts
    objective values of nearly equal size, and in float32 that cancellation
    alone moved final fidelities by up to 1.1e-4 against the float64 path
    (64 flagship lanes on the CPU; 1.2e-6 with this fit in float64).
    :return: (alpha (B,) in the working real dtype, small_step (B,) bool)."""
    rdtype = U_guess.dtype
    wide = lambda t: t.to(torch.complex128 if t.is_complex() else torch.float64)
    Q_s, R_s, X_ref, U_ref = wide(Q_s), wide(R_s), wide(X_ref), wide(U_ref)
    X_guess, U_guess = wide(X_guess), wide(U_guess)
    dX = wide(X_opt) - X_guess
    dU = wide(U_opt) - U_guess

    def phi(a):
        return objective_value(X_guess + a * dX, U_guess + a * dU, X_ref, U_ref, Q_s, R_s)

    p0, ph, p1 = phi(0.0), phi(0.5), phi(1.0)
    a = 2.0 * (p1 + p0 - 2.0 * ph)
    b = p1 - p0 - a
    curved = a.abs() > 1e-30
    alpha = torch.where(curved, -b / (2.0 * torch.where(curved, a, torch.ones_like(a))),
                        torch.ones_like(a))
    alpha = torch.where(torch.isfinite(alpha), alpha, torch.ones_like(alpha))
    alpha = torch.clamp(alpha, 0.0, 1.0)
    dz_norm = torch.sqrt(dX.abs().pow(2).sum(dim=(1, 2)) + dU.abs().pow(2).sum(dim=(1, 2)))
    return alpha.to(rdtype), alpha.abs() * dz_norm < step_tol


def sqp_update_from_qp(s: SQPState, res: QPResult, X_ref, U_ref, Q_s, R_s,
                       single_shot: bool, step_tol: float) -> SQPState:
    """Apply one QP result to the SQP state: failure codes, line search (or
    the full step when single-shot), and the guess blend, which a failed
    lane skips."""
    code = torch.where(~res.converged, 2,
                       torch.where(~torch.isfinite(res.obj), 3, 0)).to(torch.int32)
    if single_shot:
        alpha = torch.ones_like(res.obj)
        iqp_done = torch.ones_like(s.done)
    else:
        alpha, small = _line_search_alpha(Q_s, R_s, X_ref, U_ref, s.Xg, s.Ug,
                                          res.X, res.U, step_tol)
        iqp_done = small | (code > 0)
    ok = code == 0
    step = ok.to(alpha.dtype) * alpha
    # the dual carriers take a successful solve's (y, rho); a solver
    # without duals (the LQR) leaves them as they are
    y, rho = s.y, s.rho
    if res.y is not None:
        y = torch.where(ok[:, None], res.y.to(s.y.dtype), s.y)
        rho = torch.where(ok, res.rho.to(s.rho.dtype), s.rho)
    return SQPState(
        s.Xg + _lane(step, s.Xg) * (res.X - s.Xg),
        s.Ug + _lane(step, s.Ug) * (res.U - s.Ug),
        res.X, res.U, res.obj, s.n_iter + 1, iqp_done, code, y, rho,
    )


def observe(plants: Plant, x_plant: torch.Tensor, noise_t: Optional[torch.Tensor],
            observe_fn: Optional[Callable] = None) -> torch.Tensor:
    """The measured state of each lane: observe_fn(plants, x_plant,
    noise_t) where given, else x_plant + sigma noise_t on a plant with a
    sigma (x_plant itself when noise_t is None or the plant has none)."""
    if observe_fn is not None:
        return observe_fn(plants, x_plant, noise_t)
    sigma = getattr(plants, "sigma", None)
    if noise_t is None or sigma is None:
        return x_plant
    return x_plant + sigma.reshape(-1, 1) * noise_t


def advance(carry: Carry, s: SQPState, step: int, config: MPCConfig,
            ctx: StepContext, bmodel: BilinearModel, model,
            plants: Plant, plant_step: Callable, exit_condition: Optional[Callable] = None,
            noise_t: Optional[torch.Tensor] = None, observe_fn: Optional[Callable] = None,
            model_update_fn: Optional[Callable] = None,
            model_fns: Optional[ModelApplyFns] = None):
    """Apply each lane's first control to the plant, observe, close the loop,
    refit the model, shift the guesses and duals and book the exits. A
    lane's new code is its failed step's 2 / 3, else 1 where the exit
    condition holds, else 0; a lane that is done keeps its code.

    :param plant_step: (x_true (B, dim_e), u (B, dim_u)) -> next plant state.
    :param exit_condition: None, or (x_next, x_cur, u) -> (B,) bool,
        evaluated on every lane; a lane where it holds is done.
    :param noise_t: None, or this step's (B, n_obs) complex standard normal
        draws of the observation (`observe`).
    :param model_update_fn: None, or the streaming refit (model,
        y (B, dim_x), x (B, dim_x), u (B, Lm dim_x)) -> model on the lane
        batch of models.
    :param model_fns: None (the dense prediction) or the caller's
        `ModelApplyFns`, whose `predict` closes the loop between
        measurements.
    :return: (carry_new, duals_out, model_new) with duals_out = (y, rho)
        for the next step's warm start.
    """
    dim_u = config.dim_u
    done = carry.done
    u_apply = s.U_opt[:, :, 0]
    step_failed = s.code > 0

    x_plant = plant_step(carry.x_true, u_apply)
    is_measure = ((step + 1) % config.measure_freq) == 0
    ux = None
    if not is_measure or model_update_fn is not None:
        lift_u = bmodel.lift_u(u_apply.T)                          # (Lm, B)
        ux = krtimes(lift_u, ctx.lift_x.T)                          # (Lm*dim_x, B)
    if is_measure:
        # the observation re-seeds the loop and the true plant state alike
        x_next = observe(plants, x_plant, noise_t, observe_fn)
        x_true_next = x_next
    else:
        # between measurements the loop closes through the model
        if model_fns is not None:
            x_next = plants.proj(model_fns.predict(model.A, ctx.lift_x, ux.T))
        else:
            x_next = plants.proj(predict(model, ctx.lift_x.T, ux).T)
        x_true_next = x_plant
    if model_update_fn is not None:
        model_new = model_update_fn(model, plants.lift(x_next), ctx.lift_x, ux.T)
        model = tree_where(done | step_failed, model, model_new)
    cond_exit = (exit_condition(x_next, carry.x_cur, u_apply) if exit_condition is not None
                 else torch.zeros_like(done))
    new_code = torch.where(step_failed, s.code, cond_exit.to(s.code.dtype))

    keep = lambda old, new: torch.where(_lane(done, old), old, new)
    hold = lambda old, new: torch.where(_lane(step_failed, old), old, new)
    shift = lambda G: torch.cat([G[:, :, 1:], G[:, :, -1:]], dim=2)
    carry_new = Carry(
        keep(carry.x_cur, hold(carry.x_cur, x_next)),
        keep(carry.x_true, hold(carry.x_true, x_true_next)),
        keep(carry.X_guess, shift(s.Xg)),
        keep(carry.U_guess, shift(s.Ug)),
        keep(carry.u_last, hold(carry.u_last, u_apply)),
        keep(carry.exit_code, new_code),
        done | step_failed | cond_exit,
    )
    y_shift = torch.cat([s.y[:, dim_u:], s.y[:, -dim_u:]], dim=1)
    return carry_new, (keep(s.y, y_shift), s.rho), model


def record_row(carry: Carry, s: SQPState):
    """A step's row of the recorded trajectory, from the carry before
    `advance` and the step's SQP state: (applied u (B, dim_u), 0 where none;
    objective and SQP iterations (B,), 0 on lanes already done; active
    (B,), the lanes whose control was applied)."""
    active = ~(carry.done | (s.code > 0))
    return (torch.where(active[:, None], s.U_opt[:, :, 0], 0.0),
            torch.where(carry.done, 0.0, s.obj), torch.where(carry.done, 0, s.n_iter), active)


def lqr_seed_guess(model_A, lift_x0, X_targ, U_targ, Q_s, R_s, sat, config: MPCConfig,
                   model_fns: Optional[ModelApplyFns] = None):
    """The initial guess of config.lqr_seed: the model linearized along the
    reference's guess (repeat(lift(x0)), zero controls), the horizon solved
    by the clipped affine LQR, and its rollout taken as the guess; a lane
    whose rollout is not finite keeps the reference's guess.

    :param model_A: (dim_x, dim_z) stacked operator, shared, or (B, dim_x,
        dim_z) per lane; lift_x0: (B, dim_x) model-space initial states.
    :param X_targ, U_targ, Q_s, R_s: as the fleet runner holds them.
    :param model_fns: None (the dense linearization) or the caller's
        `ModelApplyFns`.
    :return: (X_guess (B, dim_x, H+1) complex, U_guess (B, dim_u, H) real).
    """
    H, dim_u = config.horizon, config.dim_u
    B, dim_x = lift_x0.shape
    cdtype = model_A.dtype
    Xg = lift_x0.to(cdtype)[:, :, None].expand(-1, -1, H + 1)
    Ug = torch.zeros((B, dim_u, H), dtype=lift_x0.real.dtype, device=lift_x0.device)
    if model_fns is not None:
        A_s, B_s, D_s = model_fns.linearize(model_A, Xg[:, :, :H], Ug)
    else:
        bmodel = BilinearModel.from_stacked(model_A[..., :dim_x], model_A[..., dim_x:], dim_u,
                                            config.order)
        A_s, B_s, D_s = model_along_traj(bmodel, Xg[:, :, :H], Ug)
    res = lqr_quad_program(lift_x0.to(cdtype), X_targ[:, :H + 1].to(cdtype),
                           U_targ[:, :H].to(Ug.dtype), Q_s, R_s, A_s, B_s, sat=sat,
                           Delta_s=D_s)
    finite = lambda t: torch.isfinite(t).flatten(1).all(dim=1)[:, None, None]
    return (torch.where(finite(res.X.abs()), res.X, Xg).clone(),
            torch.where(finite(res.U), res.U.to(Ug.dtype), Ug))
