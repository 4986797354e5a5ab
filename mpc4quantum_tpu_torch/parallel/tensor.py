"""Tensor-parallel layer: the stacked model operator split by rows over a
mesh axis (counterpart of mpc4quantum_tpu/parallel/tensor.py).

An n-qubit Liouville model has dim_x = 4^n (64 at 3 qubits), and its
bilinear application

    x+ = A_x x + A_u (f(u) (kr) x)      (models/dmdc.predict)

is a (dim_x, dim_x L) contraction. Each rank of the "op" axis holds a block
of dim_x / n_op rows of A and computes those rows of x+ (or of the step's
linearization A_t, B_t, Delta_t, each of whose output rows depends only on
the same rows of A); one all_gather_into_tensor over the axis's group an
application re-forms the whole. The row-parallel pattern: one collective
an application, O(dim_x) traffic a lane against O(dim_x^2 L) compute.

On a 2-D ("scenarios", "op") mesh the op axis composes with the fleet's
scenario axis (DP x TP): each scenario shard runs its own lanes and its
gathers run over its own op group only; scenario shards never communicate.

An operator argument is either the whole A (dim_x rows; the rank takes its
block, a view) or the rank's block itself (dim_x / n_op rows,
convert.operator_rows), so a rank may hold its rows only.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..mpc.driver import ModelApplyFns
from ..ops.bilinear import BilinearModel, model_along_traj
from ..ops.library import control_powers, krtimes, lift_controls
from ..utils.linalg import cx_mm
from .mesh import axis_size, gather_axis0, mesh_device_type


def op_mesh(n_scenario: int | None = None, n_op: int | None = None,
            devices: Sequence[int] | None = None) -> DeviceMesh:
    """A 1-D ("op",) mesh over n_op ranks (all when None), or with
    n_scenario a 2-D ("scenarios", "op") mesh of n_scenario x n_op ranks
    (n_op = ranks // n_scenario when None), over the given ranks or those
    of the default group. Every rank of the group calls it."""
    device_type = mesh_device_type()
    ranks = list(range(dist.get_world_size())) if devices is None else list(devices)
    if n_scenario is None:
        n_op = len(ranks) if n_op is None else n_op
        return DeviceMesh(device_type, ranks[:n_op], mesh_dim_names=("op",))
    n_op = len(ranks) // n_scenario if n_op is None else n_op
    grid = torch.tensor(ranks[: n_scenario * n_op]).reshape(n_scenario, n_op)
    return DeviceMesh(device_type, grid, mesh_dim_names=("scenarios", "op"))


def row_block(A: torch.Tensor, dim_x: int, mesh: DeviceMesh, axis_name: str = "op"):
    """This rank's rows of A (..., dim_x, dim_z), or A itself where it
    already is a block of dim_x / n_op rows.

    :raises ValueError: where dim_x is not divisible by the axis size.
    """
    n = axis_size(mesh, axis_name)
    if dim_x % n != 0:
        raise ValueError(f"dim_x={dim_x} not divisible by the '{axis_name}' axis size {n}")
    rows = dim_x // n
    if A.shape[-2] == dim_x:
        k = mesh.get_local_rank(axis_name)
        return A[..., k * rows:(k + 1) * rows, :]
    if A.shape[-2] != rows:
        raise ValueError(f"operator of {A.shape[-2]} rows is neither the whole ({dim_x}) "
                         f"nor a block of {rows}")
    return A


def gather_rows(local: torch.Tensor, dim: int, mesh: DeviceMesh, axis_name: str = "op"):
    """The blocks of every rank of the axis stacked along `dim` in rank
    order (one all_gather_into_tensor), contiguous as the dense path's."""
    return gather_axis0(local.movedim(dim, 0), mesh, axis_name).movedim(0, dim).contiguous()


def row_sharded_predict(mesh: DeviceMesh, A, lift_x, lift_ux, axis_name: str = "op"):
    """One row-parallel application of the stacked operator.

    :param A: (dim_x, dim_x L) stacked operator, or this rank's row block.
    :param lift_x: (..., dim_x) lifted state; :param lift_ux: (..., dim_x
        (L - 1)) its control Khatri-Rao lift.
    :return: (..., dim_x) next state, whole on every rank of the axis.
    """
    blk = row_block(A, lift_x.shape[-1], mesh, axis_name)
    z = torch.cat([lift_x, lift_ux.to(lift_x.dtype)], dim=-1)
    return gather_rows((blk @ z[..., None])[..., 0], -1, mesh, axis_name)


def _rollout(blk, lifts, x, mesh: DeviceMesh, axis_name: str):
    """Closed model rollout of lanes x (m, dim_x) under lifts (Lm, m, n),
    one local product and one gather a step: (m, dim_x, n + 1)."""
    xs = [x]
    for t in range(lifts.shape[-1]):
        ux = krtimes(lifts[:, :, t].to(x.dtype), x.T).T          # (m, Lm dim_x)
        local = torch.cat([x, ux], dim=-1) @ blk.T               # (m, rows)
        x = gather_rows(local, -1, mesh, axis_name)
        xs.append(x)
    return torch.stack(xs, dim=-1)


def row_sharded_rollout(mesh: DeviceMesh, A, lift_u_fn: Callable, x0, us,
                        axis_name: str = "op"):
    """Closed model rollout with the operator's rows sharded over the axis:
    each step one local row-block product and one gather.

    :param A: (dim_x, dim_x L) stacked operator, or this rank's row block.
    :param lift_u_fn: (dim_u, ...) -> (Lm, ...) monomial lift
        (BilinearModel.lift_u).
    :param x0: (dim_x,) initial lifted state; :param us: (dim_u, n) controls.
    :return: (dim_x, n + 1) trajectory, whole on every rank of the axis.
    """
    blk = row_block(A, x0.shape[-1], mesh, axis_name)
    return _rollout(blk, lift_u_fn(us)[:, None], x0[None], mesh, axis_name)[0]


def dp_tp_rollout(mesh: DeviceMesh, A, lift_u_fn: Callable, x0, us_batch,
                  scenario_axis: str = "scenarios", op_axis: str = "op"):
    """DP x TP: the scenario batch sharded over one mesh axis, the
    operator's rows over the other. Each rank runs its scenario shard's
    lanes on its row block; the gathers run over its op group only, so
    scenario shards never communicate, and each returns its own lanes.

    :param us_batch: (B, dim_u, n) per-scenario controls, B divisible by the
        scenario axis size.
    :return: (B / n_scenario, dim_x, n + 1): lanes [k B / n_scenario,
        (k + 1) B / n_scenario) of scenario shard k.
    """
    B = us_batch.shape[0]
    n_s = axis_size(mesh, scenario_axis)
    if B % n_s != 0:
        raise ValueError(f"scenario batch {B} not divisible by mesh size {n_s}")
    k, m = mesh.get_local_rank(scenario_axis), B // n_s
    blk = row_block(A, x0.shape[-1], mesh, op_axis)
    lifts = lift_u_fn(us_batch[k * m:(k + 1) * m].transpose(0, 1))   # (Lm, m, n)
    return _rollout(blk, lifts, x0.expand(m, -1), mesh, op_axis)


def tp_model_fns(mesh: DeviceMesh, dim_u: int, order: int, dim_x: int,
                 axis_name: str = "op") -> ModelApplyFns:
    """Row-sharded forms of the MPC step's two operator contractions, for
    `mpc(model_fns=)`, `batched_mpc(model_fns=)` and `sharded_mpc`.

    linearize computes this rank's rows of (A_s, B_s, Delta_s) along every
    lane's guess (ops.bilinear.model_along_traj on the row block) and
    gathers each over the axis; predict computes its rows of the model's
    next state and gathers them. The QP, the plant and the costs are the
    runner's own code, run alike on every rank of the axis.

    :param dim_x: the whole model-space dimension (rows of A), divisible by
        the axis size.
    """
    powers = control_powers(order, dim_u)[1:]
    lift_u = lambda us: lift_controls(us, powers)

    def linearize(model_A, X, U):
        blk = row_block(model_A, dim_x, mesh, axis_name)
        bm = BilinearModel.from_stacked(blk[..., :dim_x], blk[..., dim_x:], dim_u, order)
        A_s, B_s, D_s = model_along_traj(bm, X, U)
        return tuple(gather_rows(t, 2, mesh, axis_name) for t in (A_s, B_s, D_s))

    def predict(model_A, lift_x, ux):
        blk = row_block(model_A, dim_x, mesh, axis_name)
        if blk.dim() == 2:
            local = cx_mm(blk[:, :dim_x], lift_x.T) + cx_mm(blk[:, dim_x:], ux.T)
            return gather_rows(local, 0, mesh, axis_name).T
        local = (cx_mm(blk[..., :dim_x], lift_x[..., None])
                 + cx_mm(blk[..., dim_x:], ux[..., None]))[..., 0]
        return gather_rows(local, 1, mesh, axis_name)

    return ModelApplyFns(linearize=linearize, predict=predict, lift_u=lift_u)
