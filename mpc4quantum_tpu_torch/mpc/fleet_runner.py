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

All state stays on the plants' device; the loop makes no host copy.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..kernels.boxqp import MAX_N as SMALL_MAX_N, boxqp_accept, boxqp_big, boxqp_small
from ..models.dmdc import models_to, tile_lanes
from ..ops.bilinear import BilinearModel, model_along_traj
from ..plants.base import Plant
from ..solvers.boxqp import BoxQPParams
from ..solvers.condense import QPResult, qp_data, qp_finish
from .driver import (Carry, MPCConfig, SQPState, StepContext, advance, bilinear_model,
                     context, record_row, select, sqp_init, sqp_update_from_qp)


class FleetRunner:
    """Receding-horizon MPC over a lane batch; build once, `run` any number
    of times. Every steady (single-shot) QP starts from the previous
    solve's shifted dual and rho."""

    def __init__(self, config: MPCConfig, sat: float, du: Optional[float] = None,
                 warm_sqp_iters: Sequence[int] = (12,),
                 steady_qp_params: Optional[BoxQPParams] = None,
                 expm_taylor_k: int = 18, expm_max_squarings: int = 12,
                 exit_condition: Optional[Callable] = None, carry_duals: bool = True,
                 early_exit: bool = False):
        """:param warm_sqp_iters: SQP iterations of each warm step; steps past
        the tuple's end take its last entry.
        :param steady_qp_params: QP budget of the steady (single-shot)
            steps; None = config.qp_params.
        :param expm_taylor_k, expm_max_squarings: the plant expm's budget
            (benchfleet sizes it from a norm bound).
        :param exit_condition: None, or the scenario's batched
            (x_next, x_cur, u) -> (B,) bool; a lane where it holds ends
            with exit code 1.
        :param carry_duals: seed each steady QP from the previous solve's
            shifted dual and rho (the fleets); False: every QP starts cold
            (`mpc()`, as the reference loop).
        :param early_exit: end a warm step's SQP once every lane is done,
            by a host read of the done flags after each iteration
            (`mpc()`; the results are those of the full budget, since done
            lanes are frozen)."""
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
        self.qp_kernel = "small" if config.horizon * config.dim_u <= SMALL_MAX_N else "big"

    def _sqp_iter(self, s: SQPState, ctx: StepContext, bmodel: BilinearModel, Q_s, R_s,
                  qp: BoxQPParams, single_shot: bool) -> SQPState:
        H = self.config.horizon
        A_s, B_s, D_s = model_along_traj(bmodel, s.Xg[:, :, :H], s.Ug)
        P, q, lb, ub, w, M = qp_data(ctx.lift_x, ctx.X_ref, ctx.U_ref, Q_s, R_s,
                                     A_s, B_s, D_s, ctx.u_prev, self.sat, self.du)
        U_warm = s.Ug.transpose(1, 2).reshape(s.Ug.shape[0], -1)
        kw = dict(iters=qp.max_iter, rounds=qp.n_rounds, rho_scale=qp.rho0, sigma=qp.sigma,
                  alpha=qp.alpha, eps_abs=qp.eps_abs, eps_rel=qp.eps_rel,
                  acc_abs=qp.accept_abs, acc_rel=qp.accept_rel, scale=qp.scale)
        if self.qp_kernel == "small":
            solve = boxqp_small
        else:
            solve = boxqp_big
            kw.update(kinv_method=qp.kinv, ns_iters=qp.ns_iters)
        # carried duals seed single-shot (steady) solves only; warm-phase
        # iterations re-linearize aggressively and run cold. y crosses the
        # warm/steady seam unscaled, rho in the solver's space.
        seeded = single_shot and self.carry_duals
        z, y, aux = solve(P, q, lb, ub, x0=U_warm, y0=s.y if seeded else None,
                          rho0=s.rho if seeded else None, **kw)
        conv = boxqp_accept(aux, qp.eps_abs, qp.eps_rel, qp.accept_abs, qp.accept_rel)
        X_opt, U_opt, obj = qp_finish(w, M, z.to(P.dtype), ctx.X_ref, ctx.U_ref, Q_s, R_s)
        res = QPResult(X=X_opt, U=U_opt, obj=obj, converged=conv, y=y, rho=aux.rho)
        s_new = sqp_update_from_qp(s, res, ctx.X_ref, ctx.U_ref, Q_s, R_s,
                                   single_shot, self.config.step_tol)
        return select(s.done, s, s_new)

    def run(self, x0: torch.Tensor, model, plants: Plant,
            X_targ: torch.Tensor, U_targ: torch.Tensor, Q: torch.Tensor,
            R: torch.Tensor, Qf: torch.Tensor, *, record: bool = False,
            noise: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None,
            model_update_fn: Optional[Callable] = None,
            observe_fn: Optional[Callable] = None) -> dict:
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
        n_obs = getattr(plants, "n_obs", x0.shape[-1])
        x0 = x0.to(dev, plants.dtype)
        x0 = (x0.expand(B, -1) if x0.dim() == 1 else x0).clone()
        sigma = getattr(plants, "sigma", None)
        if noise is None and generator is not None:
            draw = lambda: torch.randn((cfg.n_steps, B, n_obs), generator=generator,
                                       dtype=rdtype, device=dev)
            noise = torch.complex(draw(), draw())
        if noise is None and sigma is not None and bool((sigma != 0).any()):
            raise ValueError("plants with measurement noise (sigma > 0) need `noise` or "
                             "a `generator`")
        if noise is not None:
            if tuple(noise.shape) != (cfg.n_steps, B, n_obs):
                raise ValueError(f"noise has shape {tuple(noise.shape)}, expected "
                                 f"{(cfg.n_steps, B, n_obs)}")
            noise = noise.to(dev, plants.dtype)
        streaming = cfg.streaming and model_update_fn is not None
        model = models_to(model, dev)
        if streaming and model.A.dim() == 2:
            model = tile_lanes(model, B)
        lx0 = plants.lift(x0)
        carry = Carry(
            x_cur=x0, x_true=x0.clone(),
            X_guess=lx0[:, :, None].expand(-1, -1, H + 1).clone(),
            U_guess=torch.zeros((B, dim_u, H), dtype=rdtype, device=dev),
            u_last=U_targ[:, 0].to(rdtype).expand(B, -1).clone(),
            exit_code=torch.zeros(B, dtype=torch.int32, device=dev),
            done=torch.zeros(B, dtype=torch.bool, device=dev))
        duals = (torch.zeros((B, H * dim_u), dtype=rdtype, device=dev),
                 torch.zeros(B, dtype=rdtype, device=dev))
        Q_s = torch.cat([Q.expand(H, -1, -1), Qf[None]], dim=0)
        R_s = R.expand(H, -1, -1)
        bmodel = bilinear_model(model, cfg)
        if record:
            n = cfg.n_steps
            xs = torch.empty((B, x0.shape[1], n + 1), dtype=x0.dtype, device=dev)
            xs[:, :, 0] = x0
            us = torch.empty((B, dim_u, n), dtype=rdtype, device=dev)
            objs = torch.empty((B, n), dtype=rdtype, device=dev)
            iters = torch.empty((B, n), dtype=torch.int32, device=dev)
            active = torch.empty((B, n), dtype=torch.bool, device=dev)

        def plant_step(x_true, u):
            return plants.step(x_true, u, cfg.dt, self.expm_taylor_k, self.expm_max_squarings)

        for step in range(cfg.n_steps):
            warm = step <= 1 if cfg.warm_start else True
            ctx = context(carry, step, cfg, X_targ, U_targ, plants)
            s = sqp_init(carry, duals)
            if warm:
                n_it = self.warm_sqp_iters[min(step, len(self.warm_sqp_iters) - 1)]
                for it in range(n_it):
                    s = self._sqp_iter(s, ctx, bmodel, Q_s, R_s, cfg.qp_params, False)
                    if self.early_exit and it + 1 < n_it and bool(s.done.all()):
                        break
            else:
                s = self._sqp_iter(s, ctx, bmodel, Q_s, R_s, self.steady_qp_params, True)
            if record:
                us[:, :, step], objs[:, step], iters[:, step], active[:, step] = \
                    record_row(carry, s)
            carry, duals, model = advance(
                carry, s, step, cfg, ctx, bmodel, model, plants, plant_step,
                self.exit_condition, noise_t=None if noise is None else noise[step],
                observe_fn=observe_fn, model_update_fn=model_update_fn if streaming else None)
            if streaming:
                bmodel = bilinear_model(model, cfg)
            if record:
                xs[:, :, step + 1] = carry.x_cur
        out = {"final_x": carry.x_cur, "exit_code": carry.exit_code, "model_state": model}
        if record:
            out.update(xs=xs, us=us, objs=objs, sqp_iters=iters,
                       n_valid=active.sum(dim=1, dtype=torch.int32))
        return out
