#!/usr/bin/env python3
"""Why cnot_state at horizon 250 (QP n 750, chip_smoke.cnot_h250_scenario)
needs the Newton-Schulz K^-1's last step in float64 on the card: the same
float32 fleet with the port's ns_inverse ("mixed": its last step's residual
I - K X formed in float64) and with float32's own iteration ("f32": every
step X (2I - K X) in float32, the JAX package's form).

1. Its first MPC step at B 16 and at B 2 with each form, every QP of the
   step captured: each QP's acceptance ratios (primal and dual residual over
   their thresholds; above 1 the QP fails), and how far lane 0's QPs at
   B 16 are from those at B 2 (max |dP|, |dq|: the step's SQP iterates,
   the same for every lane up to rounding).
2. The first QP's K = P + (sigma + rho) I at batch 1, 2 and 16 (one matrix
   repeated): ||I - K X||_inf of each form and of Newton-Schulz in float64
   rounded to float32, and the largest difference between the float32
   form's X at batch 1 and at batch 2 or 16.
3. B 16's captured QPs again with each form (the admm_big kernel's ADMM).
4. The whole fleet (B 16, 200 steps) with each form: completion, QP
   failures, fidelities and seconds.

    python3 perf_qp_floor.py

One JSON line a measurement, then the card's name and power limit. Without
a CUDA device it exits 1.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke as cs  # noqa: E402


def f32_ns(K, iters: int = 30, X0=None, guard: float = 0.5):
    """Cold Newton-Schulz with every step in K's dtype (the form before the
    float64 residual; ns_inverse's cold path otherwise)."""
    if X0 is not None:
        raise ValueError("f32_ns: cold builds only")
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    n1 = K.abs().sum(dim=-2).amax(dim=-1)
    ninf = K.abs().sum(dim=-1).amax(dim=-1)
    X = K.transpose(-1, -2) / (n1 * ninf)[..., None, None]
    for _ in range(iters):
        X = X @ (2.0 * eye - K @ X)
    return X


def main() -> int:
    if not torch.cuda.is_available():
        print("perf_qp_floor: no CUDA device; this runs only on a GPU", file=sys.stderr)
        return 1
    from mpc4quantum_tpu_torch.benchfleet import run_hostloop_fleet
    from mpc4quantum_tpu_torch.kernels import boxqp as boxqp_mod
    from mpc4quantum_tpu_torch.solvers import boxqp as solvers

    torch.backends.cuda.matmul.allow_tf32 = False
    forms = {"mixed": solvers.ns_inverse, "f32": f32_ns}
    solve = boxqp_mod.solve_boxqp_fixed
    plants64 = cs.make_lanes(cs.cnot_h250_scenario("cpu", torch.float64).plant, 16)

    def ratios(aux, p):
        tol_p, tol_d = solvers.accept_thresholds(aux.xmax, aux.zmax, aux.pxmax, aux.qmax,
                                                 aux.ymax, p.eps_abs, p.eps_rel, p.accept_abs,
                                                 p.accept_rel)
        return float((aux.prim / tol_p).max()), float((aux.dual / tol_d).max())

    def run(form, B, steps):
        captured = []

        def recording(P, q, lb, ub, **kw):
            out = solve(P, q, lb, ub, **kw)
            captured.append((P, q, lb, ub, {k: v for k, v in kw.items() if k != "admm"},
                             out.aux))
            return out

        sc = cs.cnot_h250_scenario(cs.DEVICE, torch.float32)
        if steps is not None:
            sc = dataclasses.replace(sc, config=dataclasses.replace(sc.config, n_steps=steps))
            boxqp_mod.solve_boxqp_fixed = recording
        solvers.ns_inverse = forms[form]
        try:
            t0 = time.perf_counter()
            metrics, _ = run_hostloop_fleet(sc, B, plants=plants64[:B].to(cs.DEVICE,
                                                                         torch.float32))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            boxqp_mod.solve_boxqp_fixed = solve
            solvers.ns_inverse = forms["mixed"]
        return metrics, captured, seconds

    step0 = {}
    for form in forms:
        for B in (16, 2):
            metrics, cap, _ = run(form, B, 1)
            step0[form, B] = cap
            cs.emit({"measure": "step0", "form": form, "B": B,
                     "completed_frac": metrics["completed_frac"],
                     "qp_fail_frac": metrics["qp_fail_frac"],
                     "ratios": [ratios(aux, kw["params"]) for *_, kw, aux in cap]})
        cs.emit({"measure": "step0_b16_vs_b2", "form": form,
                 "max_abs_dP_dq": [[float((a[0][0] - b[0][0]).abs().max()),
                                    float((a[1][0] - b[1][0]).abs().max())]
                                   for a, b in zip(step0[form, 16], step0[form, 2])]})
    P, q, lb, ub, kw, aux = step0["f32", 16][0]
    p = kw["params"]
    n = P.shape[-1]
    K = P[:1] + (p.sigma + aux.rho[:1])[:, None, None] * torch.eye(n, device=cs.DEVICE)
    eye64 = torch.eye(n, dtype=torch.float64, device=cs.DEVICE)
    builds = dict(forms, f64=lambda K, iters: f32_ns(K.double(), iters).to(K.dtype))
    rec, X1 = {"measure": "ns_residual", "n": n, "ns_iters": p.ns_iters}, {}
    for b in (1, 2, 16):
        Kb = K.expand(b, -1, -1).contiguous()
        for name, build in builds.items():
            X = build(Kb, p.ns_iters)[0]
            rec[f"{name}_B{b}"] = float((eye64 - K[0].double() @ X.double()).abs().sum(-1).max())
            if name == "f32":
                X1[b] = X
    rec["f32_X_B1_vs_B2"] = float((X1[1] - X1[2]).abs().max())
    rec["f32_X_B1_vs_B16"] = float((X1[1] - X1[16]).abs().max())
    cs.emit(rec)
    for k, (P, q, lb, ub, kw, aux) in enumerate(step0["f32", 16]):
        row = {"measure": "resolve_b16", "qp": k}
        for form, build in forms.items():
            solvers.ns_inverse = build
            out = solve(P, q, lb, ub, **kw, admm=boxqp_mod.admm_big)
            row[form] = ratios(out.aux, kw["params"])
        solvers.ns_inverse = forms["mixed"]
        cs.emit(row)
    for form in forms:
        metrics, _, seconds = run(form, 16, None)
        cs.emit({"measure": "fleet", "form": form, "B": 16,
                 "completed_frac": metrics["completed_frac"],
                 "qp_fail_frac": metrics["qp_fail_frac"],
                 "fidelity_min": metrics["fidelity_min"],
                 "fidelity_mean": metrics["fidelity_mean"], "seconds": seconds})
    print(cs.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
