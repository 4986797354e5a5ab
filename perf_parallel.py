#!/usr/bin/env python3
"""The multi-device cells on one CUDA card: how far float32 moves the
3-qubit closed loop, and where the time of chip_smoke.py's tp_3q and
sharded_fleet runs goes.

    python3 perf_parallel.py

First, chip_smoke.py's tp_3q problem (dim_x 64, the kernel route:
admm_big at n 24, expm_small at d 8) on the first 8 of its B 1024 detuned
lanes, run by batched_mpc in these forms: float64 on the CPU (the
reference), float32 on the CPU, float32 on the card with the kernels (the
8 lanes alone, and inside the whole B 1024 batch), on the card with
expm_small, admm_big or both swapped for their plain versions, and float64
on the card through the plain versions (the kernels take float32 only).
One JSON line: for each form the largest gap of the 8 lanes' final
fidelity and controls to the reference and whether the SQP iterations
equal it.

Then, on a one-rank NCCL group, one warm-up run and one run under
torch.profiler of tp_3q at B 1024 dense and through tp_model_fns, and of
the flagship at B 16384 through sharded_mpc: a JSON line each with the
device time in all, by kernel (the three kernels and NCCL's) and the busy
share against the unprofiled wall time. Last, the card's name and power
limit. Without a CUDA device it exits 1.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from mpc4quantum_tpu_torch.presets import three_qubit_problem  # noqa: E402
from perf_fleets import profiled  # noqa: E402

LANES = 8


def run(port, device, dtype, batch=LANES):
    """(final fidelity, controls, SQP iterations) of the first LANES lanes
    of tp_3q's B 1024 plants, run as a batch of `batch` of its first lanes,
    float64 on the host."""
    args, targ = three_qubit_problem(device, dtype)
    nominal64, _ = three_qubit_problem("cpu", torch.float64)
    plants = cs.make_lanes(nominal64["plant"], cs.TP3Q["batch"])[:batch].to(device, dtype)
    cfg = dataclasses.replace(args["config"], qp_backend="ns")
    res = port.batched_mpc(args["x0"], args["model_state"], plants, args["X_targ"],
                           args["U_targ"], args["Q"], args["R"], args["Qf"], cfg, args["sat"],
                           args["du"])
    return (cs.fidelity(res.xs, targ)[:LANES].cpu().double(),
            res.us[:LANES].cpu().double(), res.sqp_iters[:LANES].cpu())


def float32_gaps(port) -> dict:
    """The first JSON line (the module docstring)."""
    from mpc4quantum_tpu_torch.kernels import admm_big, boxqp, expm
    from mpc4quantum_tpu_torch.plants import quantum

    kernels = (quantum.expm_small, boxqp.admm_big)

    def swap(plain_expm: bool, plain_admm: bool):
        quantum.expm_small = expm.expm_small_ref if plain_expm else kernels[0]
        boxqp.admm_big = admm_big.admm_iters_ref if plain_admm else kernels[1]

    ref_fid, ref_us, ref_it = run(port, "cpu", torch.float64)
    forms = {"cpu_f32": ("cpu", torch.float32, LANES, False, False),
             "card_kernels": ("cuda", torch.float32, LANES, False, False),
             "card_kernels_b1024": ("cuda", torch.float32, 1024, False, False),
             "card_plain_expm": ("cuda", torch.float32, LANES, True, False),
             "card_plain_admm": ("cuda", torch.float32, LANES, False, True),
             "card_plain_both": ("cuda", torch.float32, LANES, True, True),
             "card_f64_plain": ("cuda", torch.float64, LANES, True, True)}
    out = {"lanes": LANES, "reference": "cpu float64",
           "fidelity_ref": ref_fid.tolist()}
    try:
        for name, (device, dtype, batch, plain_expm, plain_admm) in forms.items():
            swap(plain_expm, plain_admm)
            fid, us, it = run(port, device, dtype, batch)
            out[name] = {"max_abs_dfid": float((fid - ref_fid).abs().max()),
                         "max_abs_dus": float((us - ref_us).abs().max()),
                         "sqp_iters_equal": bool(torch.equal(it, ref_it)),
                         "fidelity": fid.tolist()}
    finally:
        swap(False, False)
    return out


def profile_runs(port) -> None:
    """The profiled runs (the module docstring), on a one-rank NCCL group."""
    from mpc4quantum_tpu_torch import presets
    from mpc4quantum_tpu_torch.parallel import tensor

    args, _ = three_qubit_problem("cuda", torch.float32)
    nominal64, _ = three_qubit_problem("cpu", torch.float64)
    B = cs.TP3Q["batch"]
    plants = cs.make_lanes(nominal64["plant"], B).to("cuda", torch.float32)
    cfg = dataclasses.replace(args["config"], qp_backend="ns")
    tp_args = (args["x0"], args["model_state"], plants, args["X_targ"], args["U_targ"],
               args["Q"], args["R"], args["Qf"], cfg, args["sat"], args["du"])
    sc = presets.not_state()
    flagship = cs.make_lanes(presets.not_state(device="cpu").plant,
                             cs.SHARDED["batch"]).to("cuda", torch.float32)
    fcfg = dataclasses.replace(sc.config, qp_backend="ns")
    port.init_distributed(f"tcp://localhost:{cs.free_port()}", 1, 0)
    try:
        fns = tensor.tp_model_fns(tensor.op_mesh(n_op=1), dim_u=3, order=1, dim_x=64)
        mesh = port.scenario_mesh()
        runs = {
            "tp_3q_dense": (B, lambda: port.batched_mpc(*tp_args)),
            "tp_3q_tp": (B, lambda: port.batched_mpc(*tp_args, model_fns=fns)),
            "sharded_fleet": (flagship.lanes, lambda: port.sharded_mpc(
                mesh, sc.x0, sc.model, flagship, sc.X_targ, sc.U_targ, sc.Q, sc.R, sc.Qf,
                fcfg, sc.sat, sc.du))}
        for name, (lanes, fn) in runs.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            acts = profiled(fn)
            device = sum(t for _, t in acts)
            by_kernel = {}
            for key in ("boxqp_small_kernel", "admm_big_kernel", "expm_small_kernel", "nccl"):
                times = [t for n, t in acts if key in n]
                by_kernel[key] = {"launches": len(times), "device_ms": sum(times) / 1e3}
            cs.emit({"measure": name, "batch": lanes, "wall_s": wall,
                     "device_ms": device / 1e3, "busy": device / 1e6 / wall,
                     "device_activities": len(acts), "kernels": by_kernel})
    finally:
        torch.distributed.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("perf_parallel: no CUDA device; this runs only on a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import mpc4quantum_tpu_torch as port

    print(json.dumps(float32_gaps(port)), flush=True)
    profile_runs(port)
    print(cs.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
