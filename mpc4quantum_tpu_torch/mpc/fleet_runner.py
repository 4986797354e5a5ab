"""Fleet MPC runner: the receding-horizon loop for a batch of lanes, with
the whole fleet's box QPs solved by one kernel launch per SQP iteration
(per rho round at n > 16) and the plant propagators by one kernel launch per
step (the main-path semantics of mpc4quantum_tpu/mpc/hostloop.py
`HostLoopMPC.run` with qp_impl="pallas" and plant_impl="pallas").

Schedule per MPC step:
  - warm steps (step <= 1 with warm_start): `warm_sqp_iters[step]` line-
    searched SQP iterations, each a cold QP solve (y0 = 0, rho0 = 0);
  - steady steps: one single-shot SQP iteration whose QP starts from the
    previous solve's shifted dual and rho.
One SQP iteration: linearize along each lane's guess, condense, the box-QP
solve chosen by n = H * dim_u as the reference chooses it - one
`boxqp_small` launch at n <= 16, else `boxqp_big` (a K-inverse and one
`admm_big` launch per rho round) - the acceptance rule, the exact rollout,
the guess update, and a freeze of lanes whose SQP already finished. The
advance takes one exact plant step per lane (`plants.step`: the step's
propagator from one `expm_small` launch, then rho' = U rho U^H, or
P' = kron(U, U^*) P in process space, or x' = exp(dt A(u)) x on an open
system) and books the scenario's exit condition. Every step runs for every
lane: lanes that are done stay frozen.

config.solver and config.qp_backend choose a step's solve: solver "lqr"
the clipped affine LQR, qp_backend "chol" the adaptive Cholesky ADMM (both
plain PyTorch, as the reference computes them outside its kernels), "ns"
the kernel route above. The preset fleets (benchfleet.make_runner) run "ns"
(the reference's HostLoopMPC with qp_impl="pallas"); `mpc()` and
`batched_mpc` (below) run the config they are given, without the carry.

The K-inverse carry (config.qp_warm_kinv, on the `boxqp_big` route of the
condensed QP only): each steady solve starts its Newton-Schulz inverse from
the inverse the previous steady solve ended with, under the contraction
guard (solvers/boxqp.solve_boxqp_fixed's kinv0), as HostLoopMPC does. The
first steady solve, and with measure_freq = m > 1 every solve at a step
divisible by m (its linearization jumps with the measurement), start cold.
An accepted solve hands its inverse on; a failed one and a done lane keep
the carried one. The carry is loop state: checkpoints hold it. The runner
counts the warm-started solves and the lanes whose guard fell back to the
cold init (`kinv_counts`).

With `model_fns` (driver.ModelApplyFns) the step's linearization and the
model prediction between measurements are the caller's (the row-sharded
contractions of parallel/tensor.py); without it they are the dense
ops.bilinear.model_along_traj and models.dmdc.predict.

On the card a run's steps are replays of CUDA graphs that mpc/step_graphs.py
captures once per signature of the run's inputs (process-wide, so `mpc()`
captures once); a run stays eager off the card, with model_fns, with a
streaming refit and on the chol QP.

All state stays on the plants' device; the loop makes no host copy. With a
checkpoint path, every `checkpoint_every` steps the whole loop state (carry,
duals, models, noise, the record so far, the step cursor) is copied to the
host and written atomically; a run started again with the same path resumes
from it and returns what the uninterrupted run returns.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Callable, Optional, Sequence

import torch

from ..kernels.boxqp import MAX_N as SMALL_MAX_N
from ..models.dmdc import models_to, tile_lanes, tree_map
from ..ops.bilinear import BilinearModel, model_along_traj
from ..ops.expm import taylor_budget
from ..plants.base import Plant
from ..solvers.boxqp import BoxQPParams
from ..solvers.condense import QPResult, quad_program
from ..solvers.lqr import lqr_quad_program
from ..utils.checkpoint import restore_checkpoint, save_checkpoint
from ..utils.profiling import host_flag, spans
from . import step_graphs
from .driver import (Carry, ModelApplyFns, MPCConfig, MPCResult, SQPState, StepContext,
                     advance, bilinear_model, context, lqr_seed_guess, record_row, select,
                     sqp_init, sqp_update_from_qp)


# the kernel choices of the "ns" route (FleetRunner's qp_kernel)
QP_KERNELS = ("auto", "small", "big")


class FleetRunner:
    """Receding-horizon MPC over a lane batch; build once, `run` any number
    of times. Every steady (single-shot) QP starts from the previous
    solve's shifted dual and rho. On the card a run's steps replay CUDA
    graphs captured once per signature (mpc/step_graphs.py)."""

    # capture the steps where the inputs allow it (step_graphs.eager_reason);
    # False (on an instance, or on the class for the runners that `mpc()` and
    # run_hostloop_fleet build) runs the same inputs eagerly, for tests and probes
    _graphs = True

    def __init__(self, config: MPCConfig, sat: float, du: Optional[float] = None,
                 warm_sqp_iters: Sequence[int] = (12,),
                 steady_qp_params: Optional[BoxQPParams] = None,
                 expm_taylor_k: Optional[int] = 18, expm_max_squarings: Optional[int] = 12,
                 exit_condition: Optional[Callable] = None, carry_duals: bool = True,
                 early_exit: bool = False, model_fns: Optional[ModelApplyFns] = None,
                 qp_kernel: str = "auto"):
        """:param warm_sqp_iters: SQP iterations of each warm step; steps past
        the tuple's end take its last entry.
        :param steady_qp_params: QP budget of the steady (single-shot)
            steps; None = config.qp_params.
        :param expm_taylor_k, expm_max_squarings: the plant expm's budget
            (benchfleet sizes it from a norm bound; None for a plant that
            steps without an expm).
        :param exit_condition: None, or the scenario's batched
            (x_next, x_cur, u) -> (B,) bool; a lane where it holds ends
            with exit code 1.
        :param carry_duals: seed each steady QP from the previous solve's
            shifted dual and rho (the fleets); False: every QP starts cold
            (`mpc()`, as the reference loop).
        :param early_exit: end a warm step's SQP once every lane is done,
            by a host read of the done flags after each iteration
            (`mpc()`; the results are those of the full budget, since done
            lanes are frozen).
        :param model_fns: None (the dense contractions) or a
            driver.ModelApplyFns for the linearization and the prediction.
        :param qp_kernel: the box-QP kernel of the "ns" route: "auto" =
            `boxqp_small` at n = H dim_u <= 16, `boxqp_big` above; "small"
            or "big" forces one ("small" raises ValueError above n = 16:
            the kernel keeps a QP in one team's registers)."""
        if config.solver not in ("qp", "lqr"):
            raise ValueError(f"config.solver={config.solver!r} is not 'qp' or 'lqr'")
        if not warm_sqp_iters or any(int(v) < 1 for v in warm_sqp_iters):
            raise ValueError(f"warm_sqp_iters={warm_sqp_iters!r}: need >= 1 per warm step")
        self.config = config
        self.sat = sat
        self.du = du
        self.warm_sqp_iters = tuple(int(v) for v in warm_sqp_iters)
        self.steady_qp_params = steady_qp_params or config.qp_params
        self.expm_taylor_k = expm_taylor_k
        self.expm_max_squarings = expm_max_squarings
        self.exit_condition = exit_condition
        self.carry_duals = carry_duals
        self.early_exit = early_exit
        self.model_fns = model_fns
        if qp_kernel not in QP_KERNELS:
            raise ValueError(f"qp_kernel={qp_kernel!r} is not one of {QP_KERNELS}")
        n_qp = config.horizon * config.dim_u
        if qp_kernel == "small" and n_qp > SMALL_MAX_N:
            raise ValueError(f"qp_kernel='small': boxqp_small takes n <= {SMALL_MAX_N}, this "
                             f"QP has n = {n_qp}; use 'big' or 'auto'")
        kernel = qp_kernel if qp_kernel != "auto" else (
            "small" if n_qp <= SMALL_MAX_N else "big")
        # what solves a step: the kernel "small" or "big", or plain "chol" or "lqr"
        self.qp_kernel = ("lqr" if config.solver == "lqr" else
                          kernel if config.qp_backend == "ns" else config.qp_backend)
        # the steady K-inverse carry: on the big kernel's route only (the
        # small kernel inverts inside the kernel)
        self.carry_kinv = bool(config.qp_warm_kinv and self.qp_kernel == "big")
        # seconds of each checkpoint written by the last run
        self.checkpoint_seconds: list = []
        # the last run's (2,) int64 counts on its device: steady solves
        # warm-started from the carried K-inverse, and lanes of them (not
        # done) whose guard fell back to the cold init; None without the carry
        self.kinv_counts: Optional[torch.Tensor] = None

    def _sqp_iter(self, s: SQPState, ctx: StepContext, bmodel: BilinearModel, model_A, Q_s,
                  R_s, qp: BoxQPParams, single_shot: bool, kinv0=None):
        """One SQP iteration of every lane: (the new state, the QP result)."""
        H = self.config.horizon
        with spans.span("sqp.iter"):
            with spans.span("sqp.linearize", events=True):
                if self.model_fns is not None:
                    A_s, B_s, D_s = self.model_fns.linearize(model_A, s.Xg[:, :, :H], s.Ug)
                else:
                    A_s, B_s, D_s = model_along_traj(bmodel, s.Xg[:, :, :H], s.Ug)
            if self.qp_kernel == "lqr":
                lres = lqr_quad_program(ctx.lift_x, ctx.X_ref, ctx.U_ref, Q_s, R_s, A_s, B_s,
                                        sat=self.sat, Delta_s=D_s)
                # a non-finite rollout (NaN or inf gains) is a solver failure
                ok = (torch.isfinite(lres.X.abs()).flatten(1).all(dim=1)
                      & torch.isfinite(lres.U).flatten(1).all(dim=1))
                res = QPResult(X=lres.X, U=lres.U, obj=lres.cost, converged=ok)
            else:
                # carried duals seed single-shot (steady) solves only; warm-phase
                # iterations re-linearize aggressively and run cold. y crosses the
                # warm/steady seam unscaled, rho in the solver's space.
                seeded = single_shot and self.carry_duals
                res = quad_program(ctx.lift_x, ctx.X_ref, ctx.U_ref, Q_s, R_s, A_s, B_s, D_s,
                                   ctx.u_prev, self.sat, self.du, U_warm=s.Ug, params=qp,
                                   backend=self.config.qp_backend,
                                   Y_warm=s.y if seeded else None,
                                   rho_warm=s.rho if seeded else None, kinv0=kinv0,
                                   kernel=self.qp_kernel if self.qp_kernel in ("small", "big")
                                   else None)
            s_new = sqp_update_from_qp(s, res, ctx.X_ref, ctx.U_ref, Q_s, R_s,
                                       single_shot, self.config.step_tol)
            return select(s.done, s, s_new), res

    def step(self, step: int, carry: Carry, duals, model, bmodel: BilinearModel, plants: Plant,
             X_targ: torch.Tensor, U_targ: torch.Tensor, Q_s: torch.Tensor, R_s: torch.Tensor,
             kinv=None, kinv_counts=None, **advance_kw):
        """One receding-horizon step of every lane: the step's SQP (at a warm
        step `warm_sqp_iters` cold iterations, else one single-shot
        iteration from the carried `duals` and K-inverse), then
        `driver.advance` with the runner's exit condition and model
        functions (`advance_kw`: its noise_t, observe_fn, model_update_fn).

        :param Q_s, R_s: (H + 1, dim_x, dim_x) and (H, dim_u, dim_u) costs.
        :param kinv, kinv_counts: the K-inverse carry and its counts (`run`).
        :return: (carry, duals, model, the step's SQPState, kinv).
        """
        cfg = self.config
        warm = step <= 1 or not cfg.warm_start
        with spans.span("fleet.step", phase="warm" if warm else "steady", graph="eager"):
            ctx = context(carry, step, cfg, X_targ, U_targ, plants)
            s = sqp_init(carry, duals)
            if warm:
                n_it = self.warm_sqp_iters[min(step, len(self.warm_sqp_iters) - 1)]
                for it in range(n_it):
                    s, _ = self._sqp_iter(s, ctx, bmodel, model.A, Q_s, R_s, cfg.qp_params,
                                          False)
                    if self.early_exit and it + 1 < n_it and host_flag(s.done.all()):
                        break
            else:
                s, res = self._sqp_iter(s, ctx, bmodel, model.A, Q_s, R_s,
                                        self.steady_qp_params, True, kinv0=kinv)
                if self.carry_kinv:
                    kinv = self._carry_kinv(kinv, res, carry.done, kinv_counts)
            carry, duals, model = advance(carry, s, step, cfg, ctx, bmodel, model, plants,
                                          self._plant_stepper(plants), self.exit_condition,
                                          model_fns=self.model_fns, **advance_kw)
            return carry, duals, model, s, kinv

    def _plant_stepper(self, plants: Plant) -> Callable:
        """The plant step that a step hands to `driver.advance`, in the span
        plant.step."""
        cfg = self.config

        def plant_step(x_true, u):
            with spans.span("plant.step", events=True):
                return plants.step(x_true, u, cfg.dt, self.expm_taylor_k,
                                   self.expm_max_squarings)
        return plant_step

    def run(self, x0: torch.Tensor, model, plants: Plant,
            X_targ: torch.Tensor, U_targ: torch.Tensor, Q: torch.Tensor,
            R: torch.Tensor, Qf: torch.Tensor, *, record: bool = False,
            noise: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None,
            model_update_fn: Optional[Callable] = None,
            observe_fn: Optional[Callable] = None,
            checkpoint_path: Optional[str] = None, checkpoint_every: int = 0,
            resume: bool = True, progress_every: int = 0) -> dict:
        """Run the batched loop on the plants' device.

        :param x0: (dim_e,) shared or (B, dim_e) per-lane initial states.
        :param model: a model with a stacked operator `.A` (models/dmdc.py),
            shared by the lanes, or a lane batch of them (A (B, dim_x, dim_z)).
        :param plants: lane batch (leading axis B) of any plant kind.
        :param record: also return the per-step record (below).
        :param noise: (n_steps, B, n_obs) complex standard normal draws of the
            observations, step t's used at step t where it is a measurement
            step; or None and `generator` (on the plants' device) draws them
            before the loop, real parts then imaginary. A plant with
            sigma > 0 needs one of the two; without either the observation
            is noiseless.
        :param model_update_fn: with config.streaming, the per-lane refit
            (model, y, x, u) -> model (e.g. models.dmdc.online_fit_iteration);
            each lane carries its own model, held where the lane is done or
            its step failed.
        :param observe_fn: None (x + sigma noise) or
            (plants, x (B, dim_e), noise (B, n_obs) or None) -> (B, dim_e),
            e.g. plants.quantum.quantum_observe.
        :param checkpoint_path: None, or a file: with checkpoint_every = k
            the loop state is written there after every k-th step
            (utils.checkpoint; not after the last). With `resume` and the
            file present, the run restores it and continues from its step;
            its outputs, the record included, are those of the
            uninterrupted run. resume=False starts cold. A completed run
            deletes the file.
        :param progress_every: every k steps a heartbeat line on stderr
            (step, steps/s, lane-steps/s, the done fraction: one host read);
            0 = silent.
        :return: {"final_x": (B, dim_e) complex, "exit_code": (B,) int32,
            "model_state": the final model}, and with `record`: "xs"
            (B, dim_e, n_steps + 1) observed states with x0 first, "us"
            (B, dim_u, n_steps) applied controls (0 where none), "objs" and
            "sqp_iters" (B, n_steps) (0 on done lanes), "n_valid" (B,) the
            steps whose control was applied; all on the plants' device.
        """
        cfg = self.config
        H, dim_u = cfg.horizon, cfg.dim_u
        B, dev, rdtype = plants.lanes, plants.device, plants.real_dtype
        with spans.run(dev):
            n_obs = getattr(plants, "n_obs", x0.shape[-1])
            x0 = x0.to(dev, plants.dtype)
            x0 = (x0.expand(B, -1) if x0.dim() == 1 else x0).clone()
            sigma = getattr(plants, "sigma", None)
            if noise is None and generator is not None:
                draw = lambda: torch.randn((cfg.n_steps, B, n_obs), generator=generator,
                                           dtype=rdtype, device=dev)
                noise = draw() if plants.real_state else torch.complex(draw(), draw())
            if noise is None and sigma is not None and bool((sigma != 0).any()):
                raise ValueError("plants with measurement noise (sigma > 0) need `noise` or "
                                 "a `generator`")
            if noise is not None:
                if tuple(noise.shape) != (cfg.n_steps, B, n_obs):
                    raise ValueError(f"noise has shape {tuple(noise.shape)}, expected "
                                     f"{(cfg.n_steps, B, n_obs)}")
                noise = noise.to(dev, plants.dtype)
            streaming = cfg.streaming and model_update_fn is not None
            if streaming and not plants.streaming_ok:
                raise ValueError(f"{type(plants).__name__}: streaming model refits are not "
                                 "supported on this plant kind")
            model = models_to(model, dev)
            if streaming and model.A.dim() == 2:
                model = tile_lanes(model, B)
            # the state costs in the model's dtype (complex for a quantum model,
            # real for a classical or real-embedded one), as the reference's mpc()
            Q_s = torch.cat([Q.expand(H, -1, -1), Qf[None]], dim=0).to(dev, model.A.dtype)
            R_s = R.expand(H, -1, -1)
            lx0 = plants.lift(x0)
            X_guess = lx0[:, :, None].expand(-1, -1, H + 1).clone()
            U_guess = torch.zeros((B, dim_u, H), dtype=rdtype, device=dev)
            if cfg.lqr_seed:
                X_guess, U_guess = lqr_seed_guess(model.A, lx0, X_targ, U_targ, Q_s, R_s, self.sat,
                                                  cfg, self.model_fns)
            carry = Carry(
                x_cur=x0, x_true=x0.clone(), X_guess=X_guess, U_guess=U_guess,
                u_last=U_targ[:, 0].to(rdtype).expand(B, -1).clone(),
                exit_code=torch.zeros(B, dtype=torch.int32, device=dev),
                done=torch.zeros(B, dtype=torch.bool, device=dev))
            duals = (torch.zeros((B, H * dim_u), dtype=rdtype, device=dev),
                     torch.zeros(B, dtype=rdtype, device=dev))
            rec = None
            if record:
                n = cfg.n_steps
                rec = (torch.zeros((B, x0.shape[1], n + 1), dtype=x0.dtype, device=dev),   # xs
                       torch.zeros((B, dim_u, n), dtype=rdtype, device=dev),               # us
                       torch.zeros((B, n), dtype=rdtype, device=dev),                      # objs
                       torch.zeros((B, n), dtype=torch.int32, device=dev),                 # iters
                       torch.zeros((B, n), dtype=torch.bool, device=dev))                  # active
                rec[0][:, :, 0] = x0
            # the K-inverse carry: None until the first steady solve and after
            # each cold re-entry; kinv_counts as documented on the attribute
            kinv, kinv_counts = None, None
            if self.carry_kinv:
                kinv_counts = torch.zeros(2, dtype=torch.int64, device=dev)
            start = 0
            self.checkpoint_seconds = []
            checkpointing = bool(checkpoint_path) and checkpoint_every > 0
            if checkpoint_path and resume and os.path.exists(checkpoint_path):
                state = restore_checkpoint(checkpoint_path, self._state(
                    0, carry, duals, model, noise, rec,
                    self._kinv_slot(None, kinv_counts, B, rdtype)))
                start, carry, duals, model, noise, rec, kinv, kinv_counts = self._unpack(state)
            bmodel = bilinear_model(model, cfg)
            # measurement-aligned cold re-entry of the carry
            kinv_m = cfg.measure_freq if self.carry_kinv else 0
            graphs = step_graphs.for_run(self, plants, model, Q_s, R_s, X_targ, U_targ, x0,
                                         noise, observe_fn, streaming, record)

            last_saved = last_beat = start
            t_beat = time.perf_counter()
            for step in range(start, cfg.n_steps):
                if progress_every and step - last_beat >= progress_every:
                    elapsed = max(time.perf_counter() - t_beat, 1e-9)
                    rate = (step - start) / elapsed
                    print(f"[fleet] step {step}/{cfg.n_steps} B={B} {rate:.2f} steps/s "
                          f"({B * rate:.0f} lane-steps/s) "
                          f"done_frac={float(carry.done.float().mean()):.3f} "
                          f"elapsed={elapsed:.1f}s", file=sys.stderr, flush=True)
                    last_beat = step
                if kinv_m > 1 and step % kinv_m == 0:
                    kinv = None
                noise_t = None if noise is None else noise[step]
                if graphs is None:
                    prev = carry
                    carry, duals, model, s, kinv = self.step(
                        step, carry, duals, model, bmodel, plants, X_targ, U_targ, Q_s, R_s,
                        kinv, kinv_counts, noise_t=noise_t, observe_fn=observe_fn,
                        model_update_fn=model_update_fn if streaming else None)
                    row = record_row(prev, s) if record else None
                else:
                    carry, duals, s, kinv, row = graphs.step(
                        self, step, carry, duals, X_targ, U_targ, kinv, kinv_counts, noise_t,
                        observe_fn, record)
                if record:
                    rec[1][:, :, step], rec[2][:, step], rec[3][:, step], rec[4][:, step] = row
                if streaming:
                    bmodel = bilinear_model(model, cfg)
                if record:
                    rec[0][:, :, step + 1] = carry.x_cur
                if (checkpointing and step + 1 - last_saved >= checkpoint_every
                        and step + 1 < cfg.n_steps):
                    t0 = time.perf_counter()
                    save_checkpoint(checkpoint_path,
                                    self._state(step + 1, carry, duals, model, noise, rec,
                                                self._kinv_slot(kinv, kinv_counts, B, rdtype)))
                    self.checkpoint_seconds.append(time.perf_counter() - t0)
                    last_saved = step + 1
            self.kinv_counts = kinv_counts
            if graphs is not None:
                # the carry is the graphs' buffers, which the next run overwrites
                carry = carry._replace(x_cur=carry.x_cur.clone(),
                                       exit_code=carry.exit_code.clone())
            out = {"final_x": carry.x_cur, "exit_code": carry.exit_code, "model_state": model}
            if record:
                xs, us, objs, iters, active = rec
                out.update(xs=xs, us=us, objs=objs, sqp_iters=iters,
                           n_valid=active.sum(dim=1, dtype=torch.int32))
            if checkpoint_path and os.path.exists(checkpoint_path):
                os.remove(checkpoint_path)
            return out

    @staticmethod
    def _carry_kinv(kinv, res: QPResult, done, counts):
        """The carry after a steady solve: its inverse where the solve was
        accepted on a lane not done, else the carried one (all of its
        inverse after a cold entry); where the solve started from the carry
        (an exact inverse makes it moot), `counts` gains the warm start and
        its guard's cold fallbacks, in place."""
        if kinv is None:
            return res.kinv
        if res.guard_cold is not None:
            counts[0] += 1
            counts[1] += (res.guard_cold & ~done).sum()
        keep = (done | ~res.converged)[:, None, None]
        return torch.where(keep, kinv, res.kinv)

    def _kinv_slot(self, kinv, counts, B: int, dtype: torch.dtype):
        """The carry as checkpoint leaves: (inverse, whether it is set,
        counts); an unset carry is saved as zeros. None without the carry."""
        if not self.carry_kinv:
            return None
        n = self.config.horizon * self.config.dim_u
        dev = counts.device
        if kinv is None:
            return (torch.zeros((B, n, n), dtype=dtype, device=dev),
                    torch.tensor(False, device=dev), counts)
        return kinv, torch.tensor(True, device=dev), counts

    @staticmethod
    def _state(step: int, carry, duals, model, noise, rec, kinv_slot=None) -> dict:
        """The loop state a checkpoint holds."""
        return {"step": torch.tensor(step), "carry": carry, "duals": duals, "model": model,
                "noise": noise, "record": rec, "kinv": kinv_slot}

    @staticmethod
    def _unpack(state: dict):
        kinv, counts = None, None
        if state["kinv"] is not None:
            inv, is_set, counts = state["kinv"]
            kinv = inv if bool(is_set) else None
        return (int(state["step"]), state["carry"], state["duals"], state["model"],
                state["noise"], state["record"], kinv, counts)


def batched_mpc(x0, model_state, plants: Plant, X_targ, U_targ, Q, R, Qf,
                config: MPCConfig, sat, du=None, *, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                model_update_fn: Optional[Callable] = None,
                exit_condition: Optional[Callable] = None,
                observe_fn: Optional[Callable] = None,
                model_fns: Optional[ModelApplyFns] = None) -> MPCResult:
    """`mpc()` over a lane batch of plants with the semantics of the
    reference's `vmap(mpc)`: one fleet runner on the plants' device, warm
    steps of up to config.max_iter SQP iterations that end once every lane
    is done (a host read of the lanes' done flags after each iteration),
    steady QPs cold unless config.qp_warm_duals, the QP route of
    config.solver and config.qp_backend, per-lane exit codes.
    config.qp_warm_kinv is ignored, as the reference's mpc() ignores it:
    the K-inverse carry is the preset fleets' (benchfleet.make_runner).

    :param x0: (dim_e,) shared or (B, dim_e) per lane.
    :param plants: a lane batch (leading axis B).
    :param noise: None, or (n_steps, B, n_obs) complex standard normal
        draws; or draw them from `generator`.
    :param model_fns: None, or a driver.ModelApplyFns replacing the dense
        linearization and prediction (e.g. parallel.tensor.tp_model_fns).
    :return: MPCResult with a leading lane axis on every field but the
        model's, which keeps the lane axis only where it was refit per lane.
    """
    # a plant that steps without an expm (classical RK4) has no budget
    taylor_k, max_sq = (taylor_budget(plants.norm_bound(config.dt, sat)) if plants.uses_expm
                        else (None, None))
    runner = FleetRunner(dataclasses.replace(config, qp_warm_kinv=False), float(sat), du=du,
                         warm_sqp_iters=(config.max_iter,),
                         expm_taylor_k=taylor_k, expm_max_squarings=max_sq,
                         exit_condition=exit_condition, carry_duals=config.qp_warm_duals,
                         early_exit=True, model_fns=model_fns)
    out = runner.run(x0, model_state, plants, X_targ, U_targ, Q, R, Qf, record=True,
                     noise=noise, generator=generator, model_update_fn=model_update_fn,
                     observe_fn=observe_fn)
    model = out["model_state"]
    return MPCResult(xs=out["xs"], us=out["us"], exit_code=out["exit_code"],
                     n_valid=out["n_valid"], objs=out["objs"], sqp_iters=out["sqp_iters"],
                     model_A=model.A, model_state=model)


def mpc(x0, model_state, plant: Plant, X_targ, U_targ, Q, R, Qf, config: MPCConfig, sat,
        du=None, *, noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None, model_update_fn: Optional[Callable] = None,
        exit_condition: Optional[Callable] = None,
        observe_fn: Optional[Callable] = None,
        model_fns: Optional[ModelApplyFns] = None) -> MPCResult:
    """One closed-loop rollout: the one-lane `batched_mpc` on the plant's
    device (the card unless the caller built the plant elsewhere).

    Warm steps take up to config.max_iter line-searched SQP iterations and
    stop once the SQP is done (one host read of its done flag an
    iteration); steady steps one single-shot solve, cold unless
    config.qp_warm_duals. Each solve is config.solver's: the condensed QP
    on config.qp_backend ("chol", the reference's default; "ns" the
    `boxqp_small` / `boxqp_big` kernels) at config.qp_params, or the
    clipped LQR. The plant expm takes the budget of the plant's norm bound
    over the control box (ops.expm.taylor_budget).

    :param plant: one plant (no lane axis); x0 (dim_e,), X_targ, U_targ,
        Q, R, Qf as in a Scenario.
    :param model_state: a model (DMDcModel, OnlineDMDc, DiscrepDMDc,
        HistoryState); refit with model_update_fn when config.streaming.
    :param noise: None, or (n_steps, n_obs) complex standard normal draws of
        the observations; or draw them from `generator`. A plant with
        sigma > 0 needs one of the two.
    :param exit_condition: None, or (x_next, x_cur, u) -> bool on one lane
        of shape (1, ...), e.g. presets.DistanceExit.
    :param observe_fn: None, or (plants, x (1, dim_e), noise (1, n_obs))
        -> (1, dim_e), e.g. plants.quantum.quantum_observe.
    :param model_fns: None, or a driver.ModelApplyFns (the row-sharded
        contractions of parallel.tensor.tp_model_fns).
    """
    res = batched_mpc(x0, model_state, plant[None], X_targ, U_targ, Q, R, Qf, config, sat,
                      du, noise=None if noise is None else noise[:, None], generator=generator,
                      model_update_fn=model_update_fn, exit_condition=exit_condition,
                      observe_fn=observe_fn, model_fns=model_fns)
    model = res.model_state
    if model.A.dim() == 3:
        model = tree_map(lambda t: t[0], model)
    lane = lambda t: t[0]
    return MPCResult(xs=lane(res.xs), us=lane(res.us), exit_code=lane(res.exit_code),
                     n_valid=lane(res.n_valid), objs=lane(res.objs),
                     sqp_iters=lane(res.sqp_iters), model_A=model.A, model_state=model)
