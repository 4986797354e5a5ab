"""Process groups, device meshes and the weak-scaling harness of the fleet
layer (counterpart of mpc4quantum_tpu/parallel/mesh.py).

One process a device: `init_distributed` joins this process to a
torch.distributed group (NCCL on the card, gloo on the CPU), `fleet_mesh`
builds the 1-D "scenarios" DeviceMesh over its ranks, which the fleet
shards its lanes over (parallel/fleet.py). The rollouts are independent;
the only traffic is the gather of the results and the summary reductions.

`scaling_report` measures weak-scaling efficiency at 1..N ranks, each count
on the sub-mesh of the first n ranks.
"""

from __future__ import annotations

import os
import time
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, device: str = "cuda") -> None:
    """Join this process to the default process group.

    :param coordinator: the group's rendezvous, a torch.distributed
        init_method ("tcp://host:port", "file:///path"; a bare "host:port"
        is read as tcp). With one process and no coordinator the group is
        made in-process (a HashStore).
    :param num_processes, process_id: world size and this process's rank.
    :param device: "cuda" (NCCL; the process takes the card of index rank
        modulo the card count) or "cpu" (gloo).

    A no-op when none of the three is given and the environment names no
    group (WORLD_SIZE unset), as the reference's is single-process then;
    with WORLD_SIZE, RANK and MASTER_ADDR / MASTER_PORT set (torchrun) the
    group is read from them. A no-op too in a process already in a group.
    """
    if dist.is_initialized():
        return
    if device not in BACKENDS:
        raise ValueError(f"device={device!r} is not one of {tuple(BACKENDS)}")
    if coordinator is None and num_processes is None and process_id is None:
        if "WORLD_SIZE" not in os.environ:
            return
        coordinator = "env://"
        num_processes, process_id = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    num_processes = 1 if num_processes is None else int(num_processes)
    process_id = 0 if process_id is None else int(process_id)
    if device == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    kw = dict(backend=BACKENDS[device], world_size=num_processes, rank=process_id)
    if coordinator is None:
        if num_processes != 1:
            raise ValueError(f"{num_processes} processes need a coordinator")
        dist.init_process_group(store=dist.HashStore(), **kw)
        return
    if "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    dist.init_process_group(init_method=coordinator, **kw)


def mesh_device_type() -> str:
    """The device type of the default group's tensors: "cuda" under NCCL,
    else "cpu". A process in no group joins a one-process group on the card
    first (init_distributed(num_processes=1))."""
    if not dist.is_initialized():
        init_distributed(num_processes=1)
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """Where this rank's tensors of `mesh` live: its card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def axis_size(mesh: DeviceMesh, axis_name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis_name))


def gather_axis0(t: torch.Tensor, mesh: DeviceMesh, axis_name: str) -> torch.Tensor:
    """The tensors of every rank along `axis_name`, concatenated along dim 0
    in rank order: one all_gather_into_tensor over that axis's group (a
    complex tensor as its real view)."""
    n = axis_size(mesh, axis_name)
    src = t.contiguous()
    wire = torch.view_as_real(src) if src.is_complex() else src
    out = torch.empty((n * wire.shape[0],) + tuple(wire.shape[1:]), dtype=wire.dtype,
                      device=wire.device)
    dist.all_gather_into_tensor(out, wire, group=mesh.get_group(axis_name))
    return torch.view_as_complex(out) if src.is_complex() else out


def fleet_mesh(axis_name: str = "scenarios", devices: Sequence[int] | None = None) -> DeviceMesh:
    """1-D mesh named `axis_name` over the given ranks (all ranks of the
    default group when None). Every rank of the group calls it, also one
    left out of `devices`."""
    device_type = mesh_device_type()
    ranks = list(range(dist.get_world_size())) if devices is None else list(devices)
    return DeviceMesh(device_type, ranks, mesh_dim_names=(axis_name,))


def scaling_report(run_shard_fn, batch_per_device: int, device_counts: Sequence[int],
                   reps: int = 2) -> list[dict]:
    """Weak-scaling efficiency: `run_shard_fn(mesh, total_batch)` on the
    sub-mesh of the first n ranks for each n in device_counts, with
    batch_per_device lanes a rank. Every rank of the group calls it; the
    ranks outside a sub-mesh wait. Each run is timed on the host between
    barriers of the sub-mesh (an all_reduce, then the card's
    synchronize); a row's best_s is the slowest rank's best of `reps` runs
    after one warm-up.

    :param run_shard_fn: (mesh, batch) -> outputs.
    :return: [{devices, batch, best_s, per_device_throughput, efficiency}],
        the same on every rank (efficiency relative to the first row).
    """
    mesh_device_type()  # a process in no group joins a one-process group
    rows, base, rank = [], None, dist.get_rank()
    for n_dev in device_counts:
        mesh = fleet_mesh(devices=range(n_dev))
        device = mesh_device(mesh)
        batch = batch_per_device * n_dev
        best = 0.0
        if rank < n_dev:
            group = mesh.get_group("scenarios")
            token = torch.zeros(1, device=device)

            def sync():
                # a barrier of the sub-mesh that the card runs in order
                dist.all_reduce(token, group=group)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)

            run_shard_fn(mesh, batch)  # warm-up
            times = []
            for _ in range(reps):
                sync()
                t0 = time.perf_counter()
                run_shard_fn(mesh, batch)
                sync()
                times.append(time.perf_counter() - t0)
            best = min(times)
        slowest = torch.tensor([best], dtype=torch.float64, device=device)
        dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
        best = float(slowest)
        thr = batch / best / n_dev
        base = thr if base is None else base
        rows.append({"devices": n_dev, "batch": batch, "best_s": best,
                     "per_device_throughput": thr, "efficiency": thr / base})
    return rows
