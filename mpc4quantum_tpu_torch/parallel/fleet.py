"""Lane batches of perturbed plants, batched rollouts and their shards over
a mesh of processes (counterpart of mpc4quantum_tpu/parallel/fleet.py;
`batched_mpc` is the fleet runner's, mpc/fleet_runner.py).

    mpc (one lane)  ->  batched_mpc (a lane batch)  ->  sharded_mpc (lanes over ranks)

`sharded_mpc` gives each rank of the mesh's "scenarios" axis an equal
slice of the lanes, which it runs with `batched_mpc` on its own device;
one all_gather a result field then gives every rank the whole result in
lane order. `sharded_fleet_summary` reduces each rank's slice locally and
combines the slices with one all_reduce a metric.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..models.dmdc import models_to, tree_map
from ..mpc.driver import MPCConfig, MPCResult
from ..mpc.fleet_runner import batched_mpc
from ..plants.base import Plant
from .mesh import axis_size, fleet_mesh, gather_axis0, mesh_device

__all__ = ["make_scenario_batch", "batched_mpc", "fleet_summary", "scenario_mesh",
           "sharded_mpc", "sharded_fleet_summary"]


def make_scenario_batch(base_plant: Plant, n: int, detune_scale: float = 0.01,
                        generator: Optional[torch.Generator] = None,
                        device=None, dtype: Optional[torch.dtype] = None) -> Plant:
    """n plants with the kind's drift field (`Plant.drift`) scaled by
    (1 + eps), eps ~ N(0, detune_scale^2): H0 of a quantum or synthesis
    plant, AH0 of a Lindblad plant, whose dissipator AD stays physical, a
    classical plant's parameter; a wrapper (the real-embedded plant) passes
    the draw to the plant it wraps. The drive is left as it is.

    The draws are made in float64 by a CPU generator and only then moved to
    `device` in `dtype` (the real dtype; by default the base plant's device
    and dtype), so one seed gives the same plants on the CPU and on the
    card. `torch.Generator` and `jax.random` give different numbers from
    one seed; parity tests pass JAX-drawn plants in.
    """
    generator = generator if generator is not None else torch.Generator().manual_seed(1)
    eps = detune_scale * torch.randn(n, generator=generator, dtype=torch.float64)

    def lanes(t: torch.Tensor) -> torch.Tensor:
        t = t.to("cpu", torch.complex128 if t.is_complex() else torch.float64)
        return t.expand(n, *t.shape).clone()

    def batch(plant: Plant) -> Plant:
        # the tensor fields; a plant's settings (its measurement adapter) carry over
        fields = {name: batch(t) if isinstance(t, Plant) else lanes(t)
                  for name, t in plant.tensor_fields().items()}
        if plant.drift is not None:
            t = fields[plant.drift]
            fields[plant.drift] = t * (1.0 + eps).reshape((n,) + (1,) * (t.dim() - 1))
        return dataclasses.replace(plant, **fields)

    return batch(base_plant).to(base_plant.device if device is None else device,
                                base_plant.real_dtype if dtype is None else dtype)


def fleet_summary(result: MPCResult, target) -> dict:
    """The batch's summary scalars: fidelity Re <target, x_final> (mean and
    min), the completed fraction (exit code 0 or 1) and the mean SQP
    iterations a step, as 0-dim tensors on the result's device.

    :param target: (dim_e,) target state.
    """
    xf = result.xs[..., -1]
    target = torch.as_tensor(target).to(xf.device, xf.dtype)
    fid = (xf * target.conj()).sum(dim=-1).real
    ok = (result.exit_code == 0) | (result.exit_code == 1)
    return {"fidelity_mean": fid.mean(), "fidelity_min": fid.min(),
            "completed_frac": ok.float().mean(),
            "sqp_iters_mean": result.sqp_iters.float().mean()}


def scenario_mesh(devices=None, axis_name: str = "scenarios") -> DeviceMesh:
    """1-D mesh over all (or the given) ranks of the default group; a
    process in no group joins a one-process group on the card
    (parallel.mesh.fleet_mesh)."""
    return fleet_mesh(axis_name, devices)


def _shard(mesh: DeviceMesh, n: int, axis_name: str) -> slice:
    """This rank's lanes of a batch of n along `axis_name`."""
    n_dev = axis_size(mesh, axis_name)
    if n % n_dev != 0:
        raise ValueError(f"scenario batch {n} not divisible by mesh size {n_dev}")
    k, m = mesh.get_local_rank(axis_name), n // n_dev
    return slice(k * m, (k + 1) * m)


def sharded_mpc(mesh: DeviceMesh, x0, model_state, plants: Plant, X_targ, U_targ, Q, R, Qf,
                config: MPCConfig, sat, du=None, *, noise: Optional[torch.Tensor] = None,
                axis_name: str = "scenarios", **mpc_kwargs) -> MPCResult:
    """`batched_mpc` with the lanes sharded over the mesh's `axis_name`.

    Every rank passes the whole batch (the same plants, x0 and noise); rank
    k of the axis runs lanes [k B/n, (k+1) B/n) with `batched_mpc` on its
    device (parallel.mesh.mesh_device), the rest of the arguments moved
    there, and each field of the result is all-gathered over the axis, so
    every rank returns the global MPCResult in lane order. A lane batch of
    models is sharded and gathered as the lanes are (so is one refit per
    lane); a shared model comes back as the rank's own. On a
    2-D ("scenarios", "op") mesh the ranks of one scenario shard run the
    same lanes, which composes with `model_fns=tp_model_fns(mesh, ...)`
    (DP x TP).

    :param noise: None, or the whole batch's (n_steps, B, n_obs) draws.
    :param mpc_kwargs: batched_mpc's keywords (model_update_fn,
        exit_condition, observe_fn, model_fns).
    :raises ValueError: where the axis size does not divide the batch.
    """
    lanes = _shard(mesh, plants.lanes, axis_name)
    dev = mesh_device(mesh)
    to = lambda t: t.to(dev) if torch.is_tensor(t) else t
    x0 = to(torch.as_tensor(x0))
    model = models_to(model_state, dev)
    if model.A.dim() == 3:  # a lane batch of models
        model = tree_map(lambda t: t[lanes], model)
    res = batched_mpc(x0[lanes] if x0.dim() == 2 else x0, model,
                      plants[lanes].to(dev), to(X_targ), to(U_targ), to(Q), to(R), to(Qf),
                      config, sat, du, noise=None if noise is None else to(noise[:, lanes]),
                      **mpc_kwargs)
    gather = lambda t: gather_axis0(t, mesh, axis_name)
    model = res.model_state
    if model.A.dim() == 3:
        model = tree_map(gather, model)
    return MPCResult(xs=gather(res.xs), us=gather(res.us), exit_code=gather(res.exit_code),
                     n_valid=gather(res.n_valid), objs=gather(res.objs),
                     sqp_iters=gather(res.sqp_iters), model_A=model.A, model_state=model)


def sharded_fleet_summary(mesh: DeviceMesh, result: MPCResult, target,
                          axis_name: str = "scenarios") -> dict:
    """fleet_summary of a (global) result with the reduction across ranks:
    each rank reduces its lane slice locally, then one all_reduce a metric
    combines the slices over the axis, the mean of the slices' means
    (exact: the slices are equal) and the min of their minima.

    :return: the fleet_summary dict of 0-dim tensors, equal on every rank.
    """
    lanes = _shard(mesh, result.xs.shape[0], axis_name)
    local = fleet_summary(result._replace(xs=result.xs[lanes],
                                          exit_code=result.exit_code[lanes],
                                          sqp_iters=result.sqp_iters[lanes]), target)
    group, n_dev = mesh.get_group(axis_name), axis_size(mesh, axis_name)
    out = {}
    for key, value in local.items():
        value = value.clone()
        if key == "fidelity_min":
            dist.all_reduce(value, op=dist.ReduceOp.MIN, group=group)
        else:
            dist.all_reduce(value, op=dist.ReduceOp.SUM, group=group)
            value = value / n_dev
        out[key] = value
    return out
