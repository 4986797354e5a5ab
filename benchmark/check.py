"""What decides `correct`: the outputs of the timed runs held against the
plain reference (reference/), computed in float64 from the same draws, on
the loop the configuration's budgets state. A budget's QP (`warm_qp`,
`steady_qp`) may state `"scale": true`: the reference then solves that
phase's QPs Jacobi-scaled, as the program does where its tuned budget
scales them, and judges the outputs against that solve; without the key
the QP is solved unscaled.

Four numbers, each with its limit from the configuration file (set from
readings of sound runs and of the reference computed in TF32, the control;
see PERF.md):
- plant_step_gap: the largest gap between x_{t+1} and the exact
  propagator of the lane's plant under the recorded control u_t applied to
  x_t (U x_t U^H, or the exponential of its Lindbladian where it has
  collapse operators) over the recorded steps: the plant step (expm) from
  the program's own states;
- track_gap: over the lanes, the TRACK_QUANTILE quantile of each lane's
  largest |x_t - x_t^ref| over the first `track_steps` recorded states:
  linearize, condense, the QP solves and the plant in closed loop. A
  quantile and not the largest: on about one lane in 10^4 float32 rounding
  flips a discrete step of the QP (whether a round's rho is rebalanced)
  and that lane's track moves by up to 2e-2 before the loop pulls it back
  (PERF.md); the quantile reads the rest, the three other numbers every
  lane;
- fidelity_gap: the largest |F - F^ref| of the final states, after any
  rescue pass: the closed-loop result;
- code_mismatch: the lanes whose exit code differs from the reference's.
The state checks read lanes that completed in the program (exit code 0);
the others are judged by their codes. Every run of the window is held to
the final numbers; the per-step numbers read every lane of the runs that
kept their record (a fleet window keeps three, drive.keep; every rollout
and every traced run keeps its own).
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import mpc_plain as ref

NUMBERS = ("plant_step_gap", "track_gap", "fidelity_gap", "code_mismatch")
TRACK_QUANTILE = 0.999


def reference_outputs(config: dict, entry: str, eps, ar: "ref.Arith") -> dict:
    """The reference's fleet (or its rollouts, lane by lane) on the draws."""
    from .spec import reference_problem

    prob = reference_problem(config)
    bud = ref.LoopBudget.from_dict(config["budgets"][entry])
    rescue = config.get("rescue") if entry == "fleet" else None
    return ref.fleet(prob, bud, eps, ar, rescue=rescue, record=True), prob


def _worse(a: float, b: float) -> float:
    """The larger, NaN if either is NaN."""
    return float("nan") if a != a or b != b else max(a, b)


def step_gap(prob, ar, eps, xs, us, ok) -> float:
    """The largest plant-step residual of recorded lanes `ok` against the
    exact propagator of the lane's plant: U x U^H, or the exponential of its
    Lindbladian where it has collapse operators."""
    if not bool(ok.any()):
        return float("nan")
    xs, us = xs[ok].to(ar.device, ar.cplx), us[ok].to(ar.device, ar.real)
    B, dx, n1 = xs.shape
    H0 = ref.lane_drifts(prob, ar, np.asarray(eps)[ok.cpu().numpy()])
    H0 = H0[:, None].expand(-1, n1 - 1, -1, -1).reshape(-1, *H0.shape[1:])
    x_t = xs[:, :, :-1].transpose(1, 2).reshape(-1, dx)
    u_t = us.transpose(1, 2).reshape(-1, us.shape[1])
    nxt = ref.plant_step(prob, ar, H0, x_t, u_t)
    return float((nxt - xs[:, :, 1:].transpose(1, 2).reshape(-1, dx)).abs().max())


def compare(config: dict, entry: str, eps, outs: list, device) -> dict:
    """The four numbers of the timed outputs `outs`: a fleet run's dict each,
    or a rollout's with its pool index "lane"; the per-step numbers read the
    outputs that kept their record ("xs", "us")."""
    ar = ref.Arith("float64", device)
    r, prob = reference_outputs(config, entry, eps, ar)
    r_fid = ref.fidelity(prob, r["final_x"])
    track = config["limits"][entry]["track_steps"]
    res = {"plant_step_gap": 0.0, "track_gap": 0.0, "fidelity_gap": 0.0, "code_mismatch": 0}
    tracks = []
    for o in outs:
        if "lane" in o:  # one rollout: a run of one lane
            idx = torch.tensor([o["lane"]], device=ar.device)
            o = {k: v[None] for k, v in o.items() if torch.is_tensor(v)}
        else:
            idx = torch.arange(len(eps), device=ar.device)
        code = o["exit_code"].to(ar.device).long()
        res["code_mismatch"] += int((code != r["exit_code"][idx]).sum())
        fid = ref.fidelity(prob, o["final_x"].to(ar.device))
        res["fidelity_gap"] = _worse(res["fidelity_gap"], float((fid - r_fid[idx]).abs().max()))
        if "xs" not in o:
            continue
        ok = code == 0
        e = np.asarray(eps)[idx.cpu().numpy()]
        res["plant_step_gap"] = _worse(res["plant_step_gap"],
                                       step_gap(prob, ar, e, o["xs"], o["us"], ok))
        xs = o["xs"].to(ar.device, ar.cplx)[ok][:, :, :track + 1]
        tracks.append((xs - r["xs"][idx][ok][:, :, :track + 1]).abs().flatten(1).amax(dim=1))
    lanes = torch.cat(tracks) if tracks else torch.zeros(0)
    res["track_gap"] = (float(torch.quantile(lanes, TRACK_QUANTILE)) if lanes.numel()
                        else float("nan"))
    return res


def verdict(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]): every number at or below its
    limit; a NaN is never within one."""
    rows = [(k, numbers[k], limits[k]) for k in NUMBERS]
    return all(v <= lim for _, v, lim in rows), rows
