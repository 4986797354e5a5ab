"""Scenario runner CLI: `python -m mpc4quantum_tpu_torch <preset> [options]`
(counterpart of `python -m mpc4quantum_tpu`, with its flags and its JSON
keys).

Runs a named preset end to end and prints one JSON line of metrics, in one
of three modes:
  - one rollout, `mpc(**scenario.mpc_args())` (the default);
  - `--batch N`: a detuning sweep of N plants through `batched_mpc`;
  - `--batch N --hostloop`: the fleet engine `run_hostloop_fleet` with the
    presets' tuned kernel budgets, which alone takes `--checkpoint`,
    `--checkpoint-every` and `--progress-every`.
The preset is built on the card (float32); with `--cpu` on the CPU
(float64), the kernels' plain versions then standing in for them. Without
`--cpu` on a machine with no card it exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="mpc4quantum_tpu_torch",
                                     description="Run a quantum-MPC benchmark scenario")
    parser.add_argument("preset", nargs="?", default="not_state",
                        help="scenario name (see --list)")
    parser.add_argument("--list", action="store_true", help="list presets and exit")
    parser.add_argument("--order", type=int, default=None, help="discretization order")
    parser.add_argument("--batch", type=int, default=0,
                        help="run a detuning-sweep fleet of this size instead of one rollout")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU in float64 (default: the card, float32)")
    parser.add_argument("--solver", choices=["qp", "lqr"], default=None)
    parser.add_argument("--checkpoint", default="",
                        help="npz path for mid-run checkpoint/resume of the hostloop "
                             "fleet; resumes automatically if the file exists")
    parser.add_argument("--checkpoint-every", type=int, default=10,
                        help="MPC steps between checkpoints (with --checkpoint)")
    parser.add_argument("--progress-every", type=int, default=0,
                        help="hostloop heartbeat on stderr every k steps (0 = silent)")
    parser.add_argument("--hostloop", action="store_true",
                        help="with --batch: run the fleet engine (benchfleet."
                             "run_hostloop_fleet) with the presets' tuned kernel budgets")
    args = parser.parse_args(argv)
    if args.hostloop and args.batch <= 0:
        parser.error("--hostloop requires --batch N (it is the fleet engine)")

    import numpy as np
    import torch

    from . import presets

    if args.list:
        for name, fn in presets.PRESETS.items():
            print(f"{name:16s} {fn.__doc__.splitlines()[0]}")
        return 0
    if args.preset not in presets.PRESETS:
        parser.error(f"unknown preset {args.preset!r}; see --list")
    if not args.cpu and not torch.cuda.is_available():
        print("mpc4quantum_tpu_torch: no CUDA device; pass --cpu to run on the CPU",
              file=sys.stderr)
        return 1

    device = "cpu" if args.cpu else "cuda"
    kwargs = {} if args.order is None else {"order": args.order}
    sc = presets.PRESETS[args.preset](device=device, **kwargs)
    if args.solver is not None:
        sc = dataclasses.replace(sc, config=dataclasses.replace(sc.config, solver=args.solver))
    if device == "cuda":
        # the complex condensed products need full float32
        torch.backends.cuda.matmul.allow_tf32 = False

    def wait():
        if device == "cuda":
            torch.cuda.synchronize()

    t0 = time.time()
    if args.batch > 0 and args.hostloop:
        from .benchfleet import run_hostloop_fleet

        metrics, _ = run_hostloop_fleet(sc, args.batch, seed=args.seed,
                                        checkpoint_path=args.checkpoint or None,
                                        checkpoint_every=args.checkpoint_every,
                                        progress_every=args.progress_every)
        out = dict(metrics, engine="hostloop")
    elif args.batch > 0:
        from .parallel.fleet import batched_mpc, fleet_summary, make_scenario_batch

        plants = make_scenario_batch(sc.plant, args.batch, detune_scale=0.01,
                                     generator=torch.Generator().manual_seed(args.seed))
        res = batched_mpc(sc.x0, sc.model, plants, sc.X_targ, sc.U_targ, sc.Q, sc.R, sc.Qf,
                          sc.config, sc.sat, du=sc.du, exit_condition=sc.exit_condition)
        wait()
        elapsed = time.time() - t0
        summary = fleet_summary(res, sc.target_state)
        out = {
            "preset": sc.name, "batch": args.batch, "elapsed_s": round(elapsed, 3),
            "rollouts_per_s": round(args.batch / elapsed, 2),
            "fidelity_mean": round(float(summary["fidelity_mean"]), 5),
            "fidelity_min": round(float(summary["fidelity_min"]), 5),
            "completed_frac": round(float(summary["completed_frac"]), 3),
        }
    else:
        from .mpc.fleet_runner import mpc

        res = mpc(**sc.mpc_args())
        wait()
        elapsed = time.time() - t0
        xf = res.xs[:, int(res.n_valid)].detach().cpu().numpy()
        fid = float(np.real(np.vdot(sc.target_state.detach().cpu().numpy(), xf)))
        out = {
            "preset": sc.name, "elapsed_s": round(elapsed, 3),
            "exit_code": int(res.exit_code), "n_valid": int(res.n_valid),
            "fidelity": round(fid, 5),
            "mean_sqp_iters": round(float(res.sqp_iters.float().mean()), 2),
        }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
