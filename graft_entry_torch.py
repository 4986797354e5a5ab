"""Entry points of the PyTorch port: one full MPC step, and a multi-device
dry run (the counterpart of __graft_entry__.py, the JAX package's).

entry() returns (fn, example_args): fn is one full MPC step of the
flagship workload (the NOT-state qubit: linearize along the guess, the
condensed box QP through the `boxqp_small` kernel, the plant step through
the `expm_small` kernel), on the card unless the caller asks for the CPU.

dryrun_multichip(n) runs the whole (tiny-shape) rollout sharded over n
ranks of a torch.distributed group (`parallel.fleet.sharded_mpc`) and holds
it against the one-process `batched_mpc` on the same lanes: an NCCL group
of n cards, or, where the caller asks for the CPU, n gloo ranks.

    python3 graft_entry_torch.py          # on the card: entry(), every card
    python3 graft_entry_torch.py --cpu 4  # on the CPU: entry(), 4 gloo ranks
"""

from __future__ import annotations

import argparse
import dataclasses
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
# seconds a gloo rank of the dry run may take
RANK_TIMEOUT = 300


def flagship(order: int = 2, horizon: int = 10, n_steps: int = 20, device="cuda",
             dtype=torch.float32):
    """The flagship scenario (`presets.not_state`, which builds the problem
    __graft_entry__._not_state_problem builds) at the given order, horizon
    and step count, on the kernel route's QP (`qp_backend="ns"`). Its
    targets keep the 20-step preset's columns: a shorter run reads the
    first of them."""
    from mpc4quantum_tpu_torch import presets

    sc = presets.not_state(order=order, device=device, dtype=dtype)
    return dataclasses.replace(sc, config=dataclasses.replace(
        sc.config, horizon=horizon, n_steps=n_steps, qp_backend="ns"))


def entry(device="cuda", dtype=torch.float32):
    """(fn, example_args): one full MPC step (step 0) of the flagship.

    fn(x0 (4,) complex, A (4, 4 L) complex, X_guess (4, H + 1) complex,
    U_guess (1, H) real) -> (x_next (4,) complex, u (1,)): the fleets' own
    step (`FleetRunner.step`) on a lane batch of one: the step's SQP
    (line-searched iterations until done or config.max_iter, each a
    linearization along the guess and one condensed QP through
    `boxqp_small`), then the first control through the plant (one
    `expm_small` launch) and the closed loop's next state; u is the applied
    control, 0 where none was. The reference's fn takes its complex
    arguments as (re, im) pairs and a PRNG key; here they go in as complex
    tensors, and the plant is noiseless.
    """
    from mpc4quantum_tpu_torch.models.dmdc import dmdc_from_operator
    from mpc4quantum_tpu_torch.mpc.driver import Carry, bilinear_model, record_row
    from mpc4quantum_tpu_torch.mpc.fleet_runner import FleetRunner
    from mpc4quantum_tpu_torch.ops.expm import taylor_budget

    sc = flagship(device=device, dtype=dtype)
    config, sat = sc.config, sc.sat
    H, dim_u, dim_x = config.horizon, config.dim_u, 4
    Q_s = torch.cat([sc.Q.expand(H, -1, -1), sc.Qf[None]], dim=0)
    R_s = sc.R.expand(H, -1, -1)
    taylor_k, squarings = taylor_budget(sc.plant.norm_bound(config.dt, sat))
    plants = sc.plant[None]  # a lane batch of one
    # the reference's step: a while loop of at most max_iter iterations
    runner = FleetRunner(config, sat, sc.du, warm_sqp_iters=(config.max_iter,),
                         expm_taylor_k=taylor_k, expm_max_squarings=squarings,
                         early_exit=True)

    def fn(x0, A, X_guess, U_guess):
        model = dmdc_from_operator(A, dim_x, dim_x, A.shape[1] - dim_x)
        zeros = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=x0.device)
        carry = Carry(x_cur=x0[None], x_true=x0[None].clone(), X_guess=X_guess[None],
                      U_guess=U_guess[None], u_last=zeros(1, dim_u),
                      exit_code=zeros(1, dt=torch.int32), done=zeros(1, dt=torch.bool))
        carry_new, _, _, s, _ = runner.step(0, carry, (zeros(1, H * dim_u), zeros(1)), model,
                                            bilinear_model(model, config), plants,
                                            sc.X_targ, sc.U_targ, Q_s, R_s)
        return carry_new.x_cur[0], record_row(carry, s)[0][0]

    example_args = (sc.x0, sc.model.A, sc.x0[:, None].expand(dim_x, H + 1).clone(),
                    torch.zeros((dim_u, H), dtype=dtype, device=sc.x0.device))
    return fn, example_args


def dryrun_problem(device="cuda", dtype=torch.float32):
    """The dry run's tiny rollout: (the flagship at order 1, H 4, 3 steps;
    its two configs). The first leaves the QP backend at the reference's
    default ("chol") and, as the reference's dry run, passes no slew bound;
    the second carries the duals on the kernel route at a Jacobi-scaled
    2x5 QP, a budget under which the first QP of every lane fails (exit
    code 2, no valid step), in the reference as here."""
    from mpc4quantum_tpu_torch.solvers.boxqp import BoxQPParams

    sc = flagship(order=1, horizon=4, n_steps=3, device=device, dtype=dtype)
    config = dataclasses.replace(sc.config, qp_backend="chol")
    warm = dataclasses.replace(config, qp_backend="ns", qp_warm_duals=True,
                               qp_params=BoxQPParams(max_iter=5, n_rounds=2, scale=True))
    return sc, (config, warm)


def dryrun_shard(world: int, device="cuda", dtype=torch.float32) -> dict:
    """The dry run on this rank of a group already joined: the tiny rollout
    (`dryrun_problem`, 2 lanes a rank) through `sharded_mpc`, held to
    `batched_mpc` on the same lanes (1e-6 on states and controls, exit codes
    equal), then once more in the carried-duals form, whose lanes must all
    end at step 0 with a failed QP. :return: the checks' numbers."""
    from mpc4quantum_tpu_torch import batched_mpc, scenario_mesh, sharded_mpc
    from mpc4quantum_tpu_torch.parallel.fleet import make_scenario_batch

    sc, (config, cfg_w) = dryrun_problem(device, dtype)
    sat, B = sc.sat, 2 * world
    plants = make_scenario_batch(sc.plant, B, detune_scale=0.01,
                                 generator=torch.Generator().manual_seed(0))
    mesh = scenario_mesh()
    args = (sc.x0, sc.model, plants, sc.X_targ, sc.U_targ, sc.Q, sc.R, sc.Qf)
    res = sharded_mpc(mesh, *args, config, sat)
    if tuple(res.us.shape) != (B, 1, config.n_steps):
        raise RuntimeError(f"dry run: us has shape {tuple(res.us.shape)}")
    if int(res.n_valid.sum()) != B * config.n_steps:
        raise RuntimeError(f"dry run: {int(res.n_valid.sum())} valid steps of {B * config.n_steps}")
    one = batched_mpc(*args, config, sat)
    gap = max(float((res.us - one.us).abs().max()), float((res.xs - one.xs).abs().max()))
    if gap > 1e-6 or not torch.equal(res.exit_code, one.exit_code):
        raise RuntimeError(f"dry run: sharded_mpc differs from batched_mpc by {gap}")
    res_w = sharded_mpc(mesh, *args, cfg_w, sat)
    if tuple(res_w.us.shape) != (B, 1, config.n_steps):
        raise RuntimeError(f"dry run (carried duals): us has shape {tuple(res_w.us.shape)}")
    if int(res_w.n_valid.sum()) != 0 or bool((res_w.exit_code != 2).any()):
        raise RuntimeError(f"dry run (carried duals): n_valid {res_w.n_valid.tolist()}, "
                           f"exit codes {res_w.exit_code.tolist()}; expected 0 and 2")
    return {"world": world, "lanes": B, "gap_to_batched": gap,
            "n_valid": int(res.n_valid.sum()), "n_valid_warm": int(res_w.n_valid.sum())}


_RANK = """
import json, sys, torch
sys.path.insert(0, sys.argv[1])
torch.set_num_threads(1)
import graft_entry_torch as g
from mpc4quantum_tpu_torch import init_distributed
rank, world, store, device = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
init_distributed(f"file://{store}", world, rank, device=device)
try:
    out = g.dryrun_shard(world, device=device, dtype=g.DRYRUN_DTYPES[device])
finally:
    torch.distributed.destroy_process_group()
if rank == 0:
    print(json.dumps(out))
"""
# the dry run's dtype on each device kind
DRYRUN_DTYPES = {"cuda": torch.float32, "cpu": torch.float64}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The sharded dry run over n ranks of a torch.distributed group: on
    the card (device="cuda") an NCCL group of n cards, one a rank, in
    float32; on the CPU (device="cpu") a gloo group in float64. With n = 1
    the rank is this process; with n > 1 each rank is a process of its own,
    joined through a file store in a temporary directory (on the card the
    parent builds the kernels first, so the ranks only load them).
    :raises RuntimeError: with fewer than n cards, or where a rank fails or
        takes longer than RANK_TIMEOUT seconds.
    :return: rank 0's numbers (dryrun_shard)."""
    import json

    import torch.distributed as dist

    from mpc4quantum_tpu_torch import init_distributed

    if n_devices < 1:
        raise ValueError(f"n_devices={n_devices}")
    if device not in DRYRUN_DTYPES:
        raise ValueError(f"device={device!r} is not one of {tuple(DRYRUN_DTYPES)}")
    if device == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) on the card: "
                           f"{torch.cuda.device_count()} CUDA devices")
    if n_devices == 1:
        init_distributed(f"tcp://localhost:{_free_port()}", 1, 0, device=device)
        try:
            return dryrun_shard(1, device=device, dtype=DRYRUN_DTYPES[device])
        finally:
            dist.destroy_process_group()
    if device == "cuda":
        from mpc4quantum_tpu_torch.kernels._build import library
        library()
    with tempfile.TemporaryDirectory() as tmp:
        store = str(Path(tmp) / "store")
        procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(ROOT), str(rank),
                                   str(n_devices), store, device],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for rank in range(n_devices)]
        outs = []
        try:
            for proc in procs:
                outs.append(proc.communicate(timeout=RANK_TIMEOUT))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        failed = [(rank, proc.returncode, err[-2000:])
                  for rank, (proc, (_, err)) in enumerate(zip(procs, outs)) if proc.returncode]
        if failed:
            raise RuntimeError(f"dry run: ranks failed: {failed}")
        return json.loads(outs[0][0].strip().splitlines()[-1])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", type=int, default=0, metavar="N",
                        help="run on the CPU (float64), the dry run over N gloo ranks")
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print("graft_entry_torch: no CUDA device; pass --cpu N", file=sys.stderr)
        return 1
    fn, example = entry(device=device, dtype=DRYRUN_DTYPES[device])
    x, u = fn(*example)
    print("entry ok:", tuple(x.shape), tuple(u.shape), float(u[0]))
    n = args.cpu or torch.cuda.device_count()
    print("dryrun_multichip ok:", dryrun_multichip(n, device=device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
