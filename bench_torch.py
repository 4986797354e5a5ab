#!/usr/bin/env python3
"""Benchmark of the PyTorch port: MPC rollouts/s of the flagship NOT-state
fleet on one CUDA card (counterpart of bench.py, the JAX package's entry).

    python3 bench_torch.py                                               # on the card
    BENCH_DEVICE=cpu BENCH_BATCH=32 BENCH_REPS=1 python3 bench_torch.py  # on the CPU

Prints ONE JSON line, the last line of stdout: the preset table first and
the flagship headline last, in bench.py's key order.

Workload (bench.py's flagship): an ideal-model qubit steered |0> -> |1>,
dt = 1, H = 10, 20 steps, sat = 2 pi 0.1, du = 0.5 sat, order-2 model, on
a lane batch of plants 1% detuned with a 1%-scale Gaussian draw a lane,
run through `benchfleet.run_hostloop_fleet` with bench.py's budgets passed
explicitly: warm SQP iterations (7, 1) at 3x12 ADMM, then one 2x10 solve
a step from the carried dual at acceptance 4e-3. Then the six-preset
table with bench.py's batches and gates, two fixed-work calibration probes
of the device, and a sequential numpy/scipy baseline of the same
receding-horizon loop (L-BFGS-B for the QP, scipy's expm for the plant).
Both the flagship and the presets run in float32.

Quality gates: flagship mean fidelity > 0.98, worst lane > 0.95,
completed >= 0.999 and baseline fidelity > 0.98, else the script exits
non-zero with no JSON line. A preset's failed gate is recorded in its
entry as gate_failed (and preset_gates_ok is false); any other exception
propagates.

Env knobs: BENCH_BATCH (16384 on the card, 1024 with BENCH_DEVICE=cpu),
BENCH_REPS (timed runs after the first, 3), BENCH_DEVICE=cpu,
BENCH_WARM_DUALS (1; 0 = cold 3x15 everywhere, no steady budget),
BENCH_WARM_ITERS ("7,1"), BENCH_QP_KERNEL ("auto"; small|big|big_unroll),
BENCH_KINV ("ns"; gj|riccati|riccati_pscan), BENCH_PRESETS ("all" on the
card, "" with BENCH_DEVICE=cpu, or a comma list), BENCH_BASELINE_REPS (5).
bench.py's knobs of TPU dispatch forms, fallbacks and watchdogs
(UNSUPPORTED) are refused.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from mpc4quantum_tpu_torch import presets
from mpc4quantum_tpu_torch.benchfleet import fleet_fidelity, run_hostloop_fleet
from mpc4quantum_tpu_torch.mpc.driver import MPCConfig
from mpc4quantum_tpu_torch.ops.liouville import discretize_homogeneous, vectorize_me
from mpc4quantum_tpu_torch.parallel.fleet import make_scenario_batch
from mpc4quantum_tpu_torch.plants.quantum import QuantumPlant
from mpc4quantum_tpu_torch.solvers.boxqp import BoxQPParams

# ---------------------------------------------------------------------------
# problem setup (bench.py's constants)
# ---------------------------------------------------------------------------

SX = np.array([[0, 1], [1, 0]], dtype=complex)
SZ = np.array([[1, 0], [0, -1]], dtype=complex)
DT, H, N_STEPS, ORDER = 1.0, 10, 20, 2
SAT = 2 * np.pi * 0.1
DU = 0.5 * SAT
WQ = 2 * np.pi * 4

DEFAULT_REPS = 3       # BENCH_REPS: timed flagship runs after the first
PRESET_REPS = 4        # a preset's runs: one warm-up, then a median of 3
# name: (batch, constructor kwargs, min-fidelity gate or None), bench.py's
# table; not_gate's quality is every lane exiting early
PRESET_SPEC = {
    "not_state_freq": (1024, {}, 0.98),
    "drag_state": (2048, {}, 0.98),
    "crosstalk": (1024, {}, 0.98),
    "cnot_state": (128, {"order": 2}, 0.99),
    "not_gate": (1024, {"n_steps": 90}, None),
    "lindblad_state": (16384, {}, 0.85),
}
# name: (fidelity threshold, constructor kwargs of the rescue scenario)
PRESET_RESCUE = {"cnot_state": (0.99, {"order": 3})}
# bench.py's knobs that choose TPU dispatch forms, the XLA/Pallas split or
# its fallback machinery: none has a counterpart here
UNSUPPORTED = ("BENCH_PATH", "BENCH_QP_IMPL", "BENCH_PLANT_IMPL", "BENCH_GRAN", "BENCH_FUSE",
               "BENCH_TRAJ", "BENCH_UNROLL", "BENCH_NO_PROBE", "BENCH_PROBE_TIMEOUT",
               "BENCH_TPU_TIMEOUT", "BENCH_NO_FALLBACK")


class GateFailed(RuntimeError):
    """A quality gate of the flagship or of a preset failed."""


def matrix_units(d):
    out = []
    for i in range(d):
        for j in range(d):
            e = np.zeros((d, d), complex)
            e[i, j] = 1
            out.append(e)
    return out


def perturbed_rho0(theta=1e-4):
    Rx = np.array([[np.cos(theta / 2), -1j * np.sin(theta / 2)],
                   [-1j * np.sin(theta / 2), np.cos(theta / 2)]])
    return (Rx @ np.diag([1.0, 0.0]).astype(complex) @ Rx.conj().T).flatten()


# ---------------------------------------------------------------------------
# CPU sequential baseline (numpy/scipy; the reference's execution model)
# ---------------------------------------------------------------------------


def cpu_baseline_rollout(detune=0.99):
    """One sequential MPC rollout on CPU: per-step python loop, per-IQP
    linearization + condensed box QP via scipy L-BFGS-B, scipy expm plant
    (bench.py's baseline, line for line)."""
    import scipy.linalg
    import scipy.optimize

    units = matrix_units(2)

    def liouville(Hm):
        # A[j,k] = -i tr(Ej^H [H, Ek])
        m = len(units)
        A = np.zeros((m, m), complex)
        for k, Ek in enumerate(units):
            C = Hm @ Ek - Ek @ Hm
            for j, Ej in enumerate(units):
                A[j, k] = -1j * np.sum(np.conj(Ej) * C)
        return A

    A0 = liouville(np.zeros((2, 2)))
    A1 = liouville(0.5 * SX)
    # order-2 frozen-u Taylor blocks: I + dtA + dt^2/2 AA over monomials 1,u,u^2
    dim = 4
    blocks = [np.eye(dim) + DT * A0 + DT**2 / 2 * (A0 @ A0),
              DT * A1 + DT**2 / 2 * (A0 @ A1 + A1 @ A0),
              DT**2 / 2 * (A1 @ A1)]
    A_op, N1, N2 = blocks

    H0_true = 0.5 * (WQ * detune - WQ) * SZ
    U_plant = lambda u: scipy.linalg.expm(-1j * DT * (H0_true + u * 0.5 * SX))

    rho0 = perturbed_rho0()
    targ = np.zeros(4, complex)
    targ[3] = 1.0
    Q = np.diag([1.0, 0, 0, 1]).astype(complex)
    Rw = 1e-2 / SAT**2

    def f_model(x, u):
        return A_op @ x + u * (N1 @ x) + u * u * (N2 @ x)

    def linearize(X_g, U_g):
        A_s, B_s, D_s = [], [], []
        for t in range(H):
            x, u = X_g[:, t], U_g[0, t]
            At = A_op + u * N1 + u * u * N2
            Bt = (N1 @ x + 2 * u * (N2 @ x)).reshape(-1, 1)
            D_s.append(f_model(x, u) - At @ x - Bt[:, 0] * u)
            A_s.append(At)
            B_s.append(Bt)
        return A_s, B_s, D_s

    def qp(x_init, A_s, B_s, D_s, u_prev):
        # condense then box-QP via L-BFGS-B
        w = [x_init]
        M = [np.zeros((4, H))]
        for t in range(H):
            w.append(D_s[t] + A_s[t] @ w[t])
            Mn = A_s[t] @ M[t]
            Mn = Mn.copy()
            Mn[:, t] += B_s[t][:, 0]
            M.append(Mn)
        w = np.stack(w)
        M = np.stack(M)

        def cost(U):
            x = w + np.einsum("txn,n->tx", M, U.astype(complex))
            ex = x - targ[None, :]
            return float(np.real(np.einsum("tx,xy,ty->", ex.conj(), Q, ex)) + Rw * U @ U)

        def grad(U):
            x = w + np.einsum("txn,n->tx", M, U.astype(complex))
            ex = x - targ[None, :]
            g = 2 * np.real(np.einsum("txn,xy,ty->n", M.conj(), Q, ex)) + 2 * Rw * U
            return g

        lb = np.full(H, -SAT)
        ub = np.full(H, SAT)
        lb[0], ub[0] = max(-SAT, u_prev - DU), min(SAT, u_prev + DU)
        res = scipy.optimize.minimize(cost, np.zeros(H), jac=grad, method="L-BFGS-B",
                                      bounds=list(zip(lb, ub)),
                                      options={"ftol": 1e-12, "maxiter": 500})
        U = res.x
        X = (w + np.einsum("txn,n->tx", M, U.astype(complex))).T
        return X, U[None, :]

    x = rho0.copy()
    X_guess = np.tile(x[:, None], (1, H + 1))
    U_guess = np.zeros((1, H))
    u_prev = 0.0
    for step in range(N_STEPS):
        n_sqp = 100 if step <= 1 else 1
        for _ in range(n_sqp):
            A_s, B_s, D_s = linearize(X_guess, U_guess)
            # u_prev quirk parity (reference mpc.py:185): the slew box is
            # referenced to the benchmark control (0) at steps 0 AND 1
            X_opt, U_opt = qp(x, A_s, B_s, D_s, u_prev if step > 1 else 0.0)
            d = np.linalg.norm(U_opt - U_guess) + np.linalg.norm(X_opt[:, :H] - X_guess[:, :H])
            X_guess, U_guess = X_opt, U_opt
            if d < 1e-4:
                break
        u = float(U_guess[0, 0])
        rho = x.reshape(2, 2)
        Up = U_plant(u)
        x = (Up @ rho @ Up.conj().T).flatten()
        u_prev = u
        X_guess = np.hstack([X_guess[:, 1:], X_guess[:, -1:]])
        U_guess = np.hstack([U_guess[:, 1:], U_guess[:, -1:]])
    return float(np.real(x.reshape(2, 2)[1, 1]))


# ---------------------------------------------------------------------------
# device calibration
# ---------------------------------------------------------------------------


def device_calibration(device: torch.device, reps: int = 3):
    """Two fixed-work probes of the device, reported beside every line so
    lines from different calls and cards can be compared:
      - calib_chain_ms: ONE program of 200 serial tanh(x @ w), x (4096, 32),
        w = 0.5 I (32 x 32), float32 with TF32 off: on the card captured
        once as a CUDA graph and replayed, on the CPU run eagerly;
      - calib_dispatch_ms: 32 separate eager launches of t + 1 on an (8,)
        tensor, then one synchronize, over 32.
    Medians of `reps` runs after a warm-up, on the host clock around a
    synchronize. They are probes of the device, not kernels of the port.
    """
    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    x = torch.ones((4096, 32), dtype=torch.float32, device=device)
    w = 0.5 * torch.eye(32, dtype=torch.float32, device=device)
    t = torch.ones(8, dtype=torch.float32, device=device)

    def chain():
        y = x
        for _ in range(200):
            y = torch.tanh(y @ w)
        return y

    run_chain = chain
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            chain()
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            chain()
        run_chain = graph.replay
    run_chain()
    t = t + 1.0
    sync()
    chain_ms, disp_ms = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        run_chain()
        sync()
        chain_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        for _ in range(32):
            t = t + 1.0
        sync()
        disp_ms.append((time.perf_counter() - t0) * 1e3 / 32)
    return round(float(np.median(chain_ms)), 2), round(float(np.median(disp_ms)), 3)


# ---------------------------------------------------------------------------
# the flagship and the preset table
# ---------------------------------------------------------------------------


def flagship(batch: int, device, dtype: torch.dtype, seed: int = 0, warm_duals: bool = True,
             kinv: str = "ns"):
    """bench.py's flagship scenario and its lane batch, on `device` in `dtype`.

    The ideal model is the order-2 discretization of the Liouvillians of
    H0 = 0 and H1 = sx / 2 on the 2 x 2 matrix units; the base plant is
    0.5 (wq 0.99 - wq) sz with the drive sx / 2; the lanes scale its drift
    by 1 + N(0, 0.01^2), drawn in float64 by a CPU generator seeded `seed`
    (bench.py draws from PRNGKey(0)). The config carries bench.py's
    warm-phase budget: 3x12 under carried duals, 3x15 cold.

    :return: (Scenario named "flagship", plant lane batch).
    """
    units = matrix_units(2)
    A_dst = discretize_homogeneous([vectorize_me(np.zeros((2, 2)), units),
                                    vectorize_me(0.5 * SX, units)], DT, ORDER)
    base = QuantumPlant.create(0.5 * (WQ * 0.99 - WQ) * SZ, [0.5 * SX], device="cpu",
                               dtype=torch.float64)
    targ = np.zeros(4, complex)
    targ[3] = 1.0
    Q = np.diag([1.0, 0, 0, 1]).astype(complex)
    config = MPCConfig(horizon=H, n_steps=N_STEPS, dt=DT, dim_u=1, order=ORDER,
                       qp_backend="ns", qp_warm_duals=warm_duals,
                       qp_params=BoxQPParams(max_iter=12 if warm_duals else 15, n_rounds=3,
                                             kinv=kinv))
    sc = presets.scenario_from_arrays(
        "flagship", x0=perturbed_rho0(), A=A_dst.numpy(),
        X_targ=np.tile(targ[:, None], (1, N_STEPS + H + 1)), U_targ=np.zeros((1, N_STEPS + H)),
        Q=Q, R=np.eye(1) * (1e-2 / SAT**2), Qf=Q, sat=SAT, du=DU, target_state=targ,
        config=config, plant=base, device=device, dtype=dtype)
    plants = make_scenario_batch(base, batch, detune_scale=0.01,
                                 generator=torch.Generator().manual_seed(seed),
                                 device=device, dtype=dtype)
    return sc, plants


def flagship_overrides(sc, warm_iters=(7, 1), qp_kernel: str = "auto") -> dict:
    """run_hostloop_fleet's (and make_runner's) overrides that give the
    flagship `sc` bench.py's budgets, whatever benchfleet's preset tables
    say: the warm SQP iterations, the carried duals of sc.config, the
    steady 2x10 solves at acceptance 4e-3 under them (none cold: every
    step then runs the warm 3x15 budget), the QP kernel and the K-inverse."""
    warm_duals, kinv = sc.config.qp_warm_duals, sc.config.qp_params.kinv
    steady = (BoxQPParams(max_iter=10, n_rounds=2, accept_abs=4e-3, accept_rel=4e-3, kinv=kinv)
              if warm_duals else None)
    return dict(warm_sqp_iters=tuple(warm_iters), warm_duals=warm_duals,
                steady_qp_params=steady, qp_kernel=qp_kernel, kinv=kinv)


def check_preset(name: str, m: dict, fid_gate) -> None:
    """bench.py's preset gates: every lane completed, no QP failure, and
    the worst lane at the gate or, without one, every lane exiting early."""
    if m["completed_frac"] != 1.0:
        raise GateFailed(f"{name}: completed_frac {m['completed_frac']}")
    if m["qp_fail_frac"] != 0.0:
        raise GateFailed(f"{name}: qp_fail_frac {m['qp_fail_frac']}")
    if fid_gate is not None and not m["fidelity_min"] >= fid_gate:
        raise GateFailed(f"{name}: fidelity_min {m['fidelity_min']} < {fid_gate}")
    if fid_gate is None and m["exit_early_frac"] != 1.0:
        raise GateFailed(f"{name}: exit_early_frac {m['exit_early_frac']}")


def run_presets(names, device, dtype) -> dict:
    """Each named preset of PRESET_SPEC through run_hostloop_fleet (seed 1,
    PRESET_REPS runs, cnot's rescue), gated by check_preset. A failed gate
    is recorded in the preset's entry as gate_failed; any other exception
    propagates."""
    results = {}
    for name in names:
        batch, kw, fid_gate = PRESET_SPEC[name]
        make = presets.PRESETS[name]
        sc = make(**kw, device=device, dtype=dtype)
        rescue = None
        if name in PRESET_RESCUE:
            threshold, rkw = PRESET_RESCUE[name]
            rescue = {"threshold": threshold, "scenario": make(**rkw, device=device, dtype=dtype)}
        m, _ = run_hostloop_fleet(sc, batch, seed=1, reps=PRESET_REPS, rescue=rescue)
        try:
            check_preset(name, m, fid_gate)
        except GateFailed as e:
            print(f"preset {name} gate failed: {e!r}", file=sys.stderr)
            m = {**m, "gate_failed": repr(e)}
        results[name] = m
    return results


def power_limit() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------


def main(env=None) -> dict:
    """Run the bench under `env` (os.environ when None), print its JSON
    line and return it. Raises SystemExit(2) on a knob of UNSUPPORTED,
    SystemExit(1) with no card unless BENCH_DEVICE=cpu, GateFailed on a
    failed flagship or baseline gate."""
    env = os.environ if env is None else env
    refused = [k for k in UNSUPPORTED if k in env]
    if refused:
        print(f"bench_torch: {', '.join(refused)}: no counterpart in the PyTorch port "
              "(TPU dispatch forms and fallbacks)", file=sys.stderr)
        raise SystemExit(2)
    on_cpu = env.get("BENCH_DEVICE") == "cpu"
    if not on_cpu and not torch.cuda.is_available():
        print("bench_torch: no CUDA device; set BENCH_DEVICE=cpu to run on the CPU",
              file=sys.stderr)
        raise SystemExit(1)
    device = torch.device("cpu" if on_cpu else "cuda")
    dtype = torch.float32
    batch = int(env.get("BENCH_BATCH", "1024" if on_cpu else "16384"))
    reps = int(env.get("BENCH_REPS", str(DEFAULT_REPS)))
    warm_duals = env.get("BENCH_WARM_DUALS", "1") == "1"
    qp_kernel = env.get("BENCH_QP_KERNEL", "auto")
    warm_iters = tuple(int(v) for v in env.get("BENCH_WARM_ITERS", "7,1").split(","))

    sc, plants = flagship(batch, device, dtype, warm_duals=warm_duals,
                          kinv=env.get("BENCH_KINV", "ns"))
    m, out_f = run_hostloop_fleet(sc, batch, plants=plants, reps=1 + reps,
                                  **flagship_overrides(sc, warm_iters, qp_kernel))
    rollouts_per_s = m["rollouts_per_s"]
    # Re(x_final . conj(target)) a lane, as bench.py reads it (|target| = 1)
    fid = fleet_fidelity(sc, out_f["final_x"])
    fid_mean, fid_min = float(fid.mean()), float(fid.min())
    codes = out_f["exit_code"].cpu().numpy()
    completed = float(((codes == 0) | (codes == 1)).mean())

    names = env.get("BENCH_PRESETS", "" if on_cpu else "all")
    names = list(PRESET_SPEC) if names == "all" else [n for n in names.split(",") if n]
    preset_results = run_presets(names, device, dtype)

    calib_chain_ms, calib_dispatch_ms = device_calibration(device)

    # the median of >= 5 sequential rollouts and their spread: the host's
    # load moves a single rollout's time
    base_reps = max(int(env.get("BENCH_BASELINE_REPS", "5")), 1)
    cpu_times = []
    for _ in range(base_reps):
        t0 = time.perf_counter()
        fid_cpu = cpu_baseline_rollout()
        cpu_times.append(time.perf_counter() - t0)
    cpu_s = float(np.median(cpu_times))
    baseline_rollouts_per_s = 1.0 / cpu_s

    # key order is emission order: the bulky preset table FIRST, the
    # flagship headline LAST, so a capture that keeps only the end of
    # stdout keeps the headline
    out = {}
    if preset_results:
        out["presets"] = preset_results
        out["preset_gates_ok"] = not any("gate_failed" in r for r in preset_results.values())
    out.update({
        "batch": batch,
        "device": "cpu" if on_cpu else torch.cuda.get_device_name(device),
        "dtype": str(dtype).replace("torch.", ""),
        **({} if on_cpu else {"power_limit": power_limit()}),
        "qp_impl": m["qp_impl"],
        "plant_impl": m["plant_impl"],
        "warm_duals": warm_duals,
        "qp_kernel": qp_kernel,
        "engine_rollouts_per_s": round(rollouts_per_s, 2),
        "baseline_rollouts_per_s": round(baseline_rollouts_per_s, 4),
        "baseline_cpu_s_per_rollout": round(cpu_s, 3),
        "baseline_cpu_s_spread": [round(min(cpu_times), 3), round(max(cpu_times), 3)],
        "baseline_cpu_fidelity": round(fid_cpu, 5),
        "calib_chain_ms": calib_chain_ms,
        "calib_dispatch_ms": calib_dispatch_ms,
        "warm_sqp_iters": list(warm_iters),
        "compile_s": round(m["first_run_s"], 1),
        "qp_solves_per_s": round(rollouts_per_s * N_STEPS, 1),
        # --- flagship headline, kept LAST (see the key-order note above) ---
        "fidelity_mean": round(fid_mean, 5),
        "fidelity_min": round(fid_min, 5),
        "completed_frac": completed,
        "metric": "mpc_rollouts_per_s",
        "value": round(rollouts_per_s, 2),
        "unit": "rollouts/s",
        "vs_baseline": round(rollouts_per_s / baseline_rollouts_per_s, 1),
    })
    # mean AND worst lane AND completion: a fleet whose tail of lanes
    # diverges must not pass on its mean
    for ok, what in ((fid_mean > 0.98, f"fleet fidelity {fid_mean}"),
                     (fid_min > 0.95, f"worst-lane fidelity {fid_min}"),
                     (completed >= 0.999, f"completed_frac {completed}"),
                     (fid_cpu > 0.98, f"baseline fidelity {fid_cpu}")):
        if not ok:
            raise GateFailed(f"quality gate failed: {what}")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
