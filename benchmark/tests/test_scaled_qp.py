"""CPU tests of the plain reference's Jacobi-scaled box QP: the scaled solve
against the program's `solve_boxqp_fixed(scale=True)` in float64, the
unscaled solve kept as it was, the TF32 control rounding the scaled solve's
K^-1 products, and the closed loop of drag_state (a leaky 3-level transmon
whose steady phase the program solves scaled) against the program's float64
fleet, with and without the scaling.

    python -m pytest benchmark/tests/test_scaled_qp.py -q
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import drive  # noqa: E402
from benchmark.reference import mpc_plain as ref  # noqa: E402
from benchmark.reference.not_state import rx  # noqa: E402


def _box_qps(n: int, B: int = 6, seed: int = 0):
    """B seeded box QPs of size n (float64): P = W W^T / n + I with its rows
    and columns spread over three decades (what the scaling equilibrates),
    q ~ N(0, 1), a box that binds some coordinates, a warm start x0."""
    g = torch.Generator().manual_seed(1000 * n + seed)
    W = torch.randn(B, n, n, generator=g, dtype=torch.float64)
    s = 10.0 ** (3.0 * torch.rand(B, n, generator=g, dtype=torch.float64) - 1.5)
    P = (W @ W.transpose(1, 2) / n + torch.eye(n, dtype=torch.float64)) * s[:, :, None] * s[:, None, :]
    q = torch.randn(B, n, generator=g, dtype=torch.float64) * s
    half = 0.2 + torch.rand(B, n, generator=g, dtype=torch.float64)
    lb, ub = -half / s, half / s
    x0 = 0.5 * torch.randn(B, n, generator=g, dtype=torch.float64) / s
    return P, q, lb, ub, x0, g


def _warm_start(q, g):
    """A dual y0 and a carried rho0 a lane, two lanes on the cold sentinel."""
    B, n = q.shape
    y0 = 0.1 * torch.randn(B, n, generator=g, dtype=torch.float64)
    rho0 = 10.0 ** (2.0 * torch.rand(B, generator=g, dtype=torch.float64) - 1.0)
    rho0[:2] = torch.tensor([0.0, -1.0], dtype=torch.float64)
    return y0, rho0


def _budget(kinv: str, scale: bool, **kw) -> ref.QPBudget:
    return ref.QPBudget(rounds=3, iters=25, rho0=0.1, sigma=1e-6, alpha=1.6, eps_abs=1e-6,
                        eps_rel=1e-6, accept_abs=1e-3, accept_rel=1e-3, kinv=kinv, ns_iters=30,
                        scale=scale, **kw)


def _program_solve(bud: ref.QPBudget, P, q, lb, ub, x0, y0, rho0):
    from mpc4quantum_tpu_torch.solvers.boxqp import BoxQPParams, accept_rule, solve_boxqp_fixed

    p = BoxQPParams(rho0=bud.rho0, sigma=bud.sigma, alpha=bud.alpha, eps_abs=bud.eps_abs,
                    eps_rel=bud.eps_rel, max_iter=bud.iters, n_rounds=bud.rounds,
                    accept_abs=bud.accept_abs, accept_rel=bud.accept_rel, ns_iters=bud.ns_iters,
                    kinv=bud.kinv, scale=bud.scale)
    res = solve_boxqp_fixed(P, q, lb, ub, x0=x0, y0=y0, rho0=rho0, params=p)
    acc = accept_rule(*res.aux[:7], p.eps_abs, p.eps_rel, p.accept_abs, p.accept_rel)
    return res.z, res.y, res.aux.rho, acc


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("kinv", ["gj", "ns"])
@pytest.mark.parametrize("n", [10, 32, 150])
def test_scaled_solve_matches_the_program(n, kinv, start):
    P, q, lb, ub, x0, g = _box_qps(n)
    y0, rho0 = _warm_start(q, g) if start == "warm" else (None, None)
    bud = _budget(kinv, scale=True)
    got = ref.solve_box_qp(ref.Arith("float64"), bud, P, q, lb, ub, x0, y0, rho0)
    want = _program_solve(bud, P, q, lb, ub, x0, y0, rho0)
    for a, b in zip(got[:3], want[:3]):
        assert float((a - b).abs().max()) <= 1e-10 * max(1.0, float(b.abs().max()))
    assert torch.equal(got[3], want[3])
    # the scaling changes the iterate at this budget: the unscaled solve is
    # another answer, and the box holds in the original coordinates
    plain = ref.solve_box_qp(ref.Arith("float64"), _budget(kinv, scale=False), P, q, lb, ub, x0,
                             y0, rho0)
    assert float((plain[0] - got[0]).abs().max()) > 1e-6
    assert bool(((got[0] >= lb - 1e-12) & (got[0] <= ub + 1e-12)).all())


def _solve_before(ar, bud, P, q, lb, ub, x0, y0=None, rho0=None):
    """solve_box_qp as it was before the reference knew the scaled form."""
    n = q.shape[-1]
    P = 0.5 * (P + P.transpose(-1, -2))
    eye = torch.eye(n, dtype=P.dtype, device=P.device)
    ds = torch.clamp(torch.diagonal(P, dim1=-2, dim2=-1).mean(dim=-1), min=1e-12)
    rho = bud.rho0 * ds
    if rho0 is not None:
        rho = torch.where(rho0 > 0, torch.clamp(rho0, 1e-8 * ds, 1e8 * ds), rho)
    x = torch.minimum(torch.maximum(x0, lb), ub)
    z = x
    y = torch.zeros_like(q) if y0 is None else y0
    sig, alpha = bud.sigma, bud.alpha
    mx = lambda v: v.abs().amax(dim=-1)
    for _ in range(bud.rounds):
        K = P + (sig + rho)[:, None, None] * eye
        Kinv = torch.linalg.inv(K) if bud.kinv == "gj" else ref.newton_schulz(ar, K, bud.ns_iters)
        r = rho[:, None]
        for _ in range(bud.iters):
            x = (Kinv @ (sig * x - q + r * z - y)[..., None])[..., 0]
            z_arg = alpha * x + (1 - alpha) * z
            z_new = torch.minimum(torch.maximum(z_arg + y / r, lb), ub)
            y = y + r * (z_arg - z_new)
            z = z_new
        Px = (P @ x[..., None])[..., 0]
        stats = mx(x - z), mx(Px + q + y), mx(x), mx(z), mx(Px), mx(q), mx(y)
        acc = ref._accepted(stats, bud.eps_abs, bud.eps_rel, bud.accept_abs, bud.accept_rel)
        prim, dual, xmax, zmax, pxmax, qmax, ymax = stats
        prim_s = prim / torch.clamp(torch.maximum(xmax, zmax), min=1e-12)
        dual_s = dual / torch.clamp(torch.maximum(pxmax, torch.maximum(qmax, ymax)), min=1e-12)
        ratio = torch.sqrt(prim_s / torch.clamp(dual_s, min=1e-16))
        rho = torch.where(acc, rho, torch.clamp(rho * ratio, 1e-8 * ds, 1e8 * ds))
    return z, y, rho, acc


@pytest.mark.parametrize("mode", ref.Arith.MODES)
@pytest.mark.parametrize("kinv", ["gj", "ns"])
def test_unscaled_solve_is_unchanged(kinv, mode):
    ar = ref.Arith(mode)
    P, q, lb, ub, x0, g = (t.to(ar.real) if torch.is_tensor(t) and t.is_floating_point() else t
                           for t in _box_qps(32))
    y0, rho0 = (t.to(ar.real) for t in _warm_start(q.double(), g))
    for args in ((), (y0, rho0)):
        bud = _budget(kinv, scale=False)
        got = ref.solve_box_qp(ar, bud, P, q, lb, ub, x0, *args)
        want = _solve_before(ar, bud, P, q, lb, ub, x0, *args)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_budget_from_dict_takes_scale():
    d = {"rounds": 1, "iters": 19, "kinv": "gj", "accept_abs": 4e-3, "accept_rel": 4e-3}
    assert ref.QPBudget.from_dict(d) == ref.QPBudget(rounds=1, iters=19, kinv="gj",
                                                     accept_abs=4e-3, accept_rel=4e-3)
    assert ref.QPBudget.from_dict(d).scale is False
    assert ref.QPBudget.from_dict({**d, "scale": True}).scale is True
    loop = ref.LoopBudget.from_dict({"warm_iters": [7, 1], "carry_duals": True,
                                     "warm_qp": {**d, "rounds": 2, "iters": 50},
                                     "steady_qp": {**d, "scale": True}})
    assert (loop.warm_qp.scale, loop.steady_qp.scale) == (False, True)


class _Float32(ref.Arith):
    """float32 with no product rounded: what the control would be without
    TF32."""

    def round(self, t):
        return t


@pytest.mark.parametrize("kinv", ["gj", "ns"])
def test_tf32_control_rounds_the_scaled_solve(monkeypatch, kinv):
    P, q, lb, ub, x0, _ = _box_qps(32)
    args32 = [t.to(torch.float32) for t in (P, q, lb, ub, x0)]
    # the library GEMMs of a solve: the same in the scaled and the unscaled one
    calls = {}
    mm = ref.Arith.mm
    for scale in (False, True):
        seen = calls[scale] = []
        monkeypatch.setattr(ref.Arith, "mm", lambda self, a, b: seen.append(
            (tuple(a.shape), tuple(b.shape))) or mm(self, a, b))
        ref.solve_box_qp(ref.Arith("tf32"), _budget(kinv, scale), *args32)
    monkeypatch.setattr(ref.Arith, "mm", mm)
    assert calls[True] == calls[False]
    assert len(calls[True]) == (0 if kinv == "gj" else 3 * (2 * 29 + 1))
    if kinv == "ns":
        # and they are rounded: the control moves off the float32 solve
        bud = _budget(kinv, scale=True)
        exact = ref.solve_box_qp(ref.Arith("float64"), bud, P, q, lb, ub, x0)[0]
        gap = lambda ar: float((ref.solve_box_qp(ar, bud, *args32)[0].double() - exact).abs().max())
        assert gap(ref.Arith("tf32")) > 2 * gap(_Float32("tf32"))


# --------------------------------------------------------------------------
# drag_state: MPC4quantum's test_DRAG_state
# --------------------------------------------------------------------------


def drag_state_problem() -> ref.Problem:
    """The drag_state preset's problem, from its stated numbers: a 3-level
    transmon in the rotating frame, H0 = alpha |2><2| with alpha = -2 pi 0.1
    / dt, drives 0.5 (a^dag + a) and 0.5 i (a^dag - a); dt 0.25, H 16, 20
    steps, order 1; rho0 |0><0| with its qubit block turned by Rx(1e-4);
    |0> and |1> populations weighted towards |1><1|; R 1e-3 / sat^2, sat 2 pi
    0.25, du 0.5 sat."""
    dt, H, n_steps, sat = 0.25, 16, 20, 2 * np.pi * 0.25
    a = np.diag([1.0, np.sqrt(2.0)], 1).astype(complex)
    proj2 = np.diag([0.0, 0.0, 1.0]).astype(complex)
    H_list = [(-2 * np.pi * 0.1 / dt) * proj2, 0.5 * (a.conj().T + a), 0.5j * (a.conj().T - a)]
    rho0 = np.zeros((3, 3), complex)
    rho0[0, 0] = 1.0
    R0 = rx(1e-4)
    rho0[:2, :2] = R0.conj().T @ rho0[:2, :2] @ R0
    targ = np.diag([0.0, 1.0, 0.0]).astype(complex).flatten()
    Q = np.diag([1.0, 0, 0, 0, 1.0, 0, 0, 0, 0]).astype(complex)
    return ref.Problem(model_H=H_list, plant_H=H_list, dt=dt, horizon=H, n_steps=n_steps, order=1,
                       x0=rho0.flatten(), target=targ,
                       X_targ=np.tile(targ[:, None], (1, n_steps + H + 1)),
                       U_targ=np.zeros((2, n_steps + H)), Q=Q, Qf=Q,
                       R=np.eye(2) * 1e-3 / sat ** 2, sat=sat, du=0.5 * sat)


# four lanes as the benchmark draws them, at 1% detuning of the anharmonicity
DRAG_EPS = drive.draws(2 ** 31 + 21, 4, 0.01)


def _qp_budget(p) -> ref.QPBudget:
    return ref.QPBudget(rounds=p.n_rounds, iters=p.max_iter, rho0=p.rho0, sigma=p.sigma,
                        alpha=p.alpha, eps_abs=p.eps_abs, eps_rel=p.eps_rel,
                        accept_abs=p.accept_abs, accept_rel=p.accept_rel, kinv=p.kinv,
                        ns_iters=p.ns_iters, scale=p.scale)


@pytest.fixture(scope="module")
def drag_program():
    """The program's float64 CPU fleet of drag_state on DRAG_EPS at
    make_runner's budgets, recorded, and the reference's budget of its
    runner."""
    from mpc4quantum_tpu_torch import presets
    from mpc4quantum_tpu_torch.benchfleet import make_runner

    sc = presets.drag_state(device="cpu", dtype=torch.float64)
    plants = drive.lane_plants(sc.plant.to("cpu", torch.float64), DRAG_EPS, "cpu", torch.float64)
    runner = make_runner(sc, plants)
    out = runner.run(sc.x0, sc.model, plants, sc.X_targ, sc.U_targ, sc.Q, sc.R, sc.Qf,
                     record=True)
    bud = ref.LoopBudget(warm_iters=runner.warm_sqp_iters,
                         warm_qp=_qp_budget(runner.config.qp_params),
                         steady_qp=_qp_budget(runner.steady_qp_params),
                         carry_duals=runner.carry_duals, step_tol=runner.config.step_tol)
    return sc, out, bud


def test_drag_problem_is_the_presets(drag_program):
    sc, _, _ = drag_program
    prob = drag_state_problem()
    c = lambda t: t.detach().cpu().to(torch.complex128).numpy()
    assert np.abs(c(sc.x0) - prob.x0).max() < 1e-15
    assert np.abs(c(sc.target_state) - prob.target).max() == 0
    assert np.abs(c(sc.Q) - prob.Q).max() == 0 and np.abs(c(sc.Qf) - prob.Qf).max() == 0
    assert np.abs(c(sc.R) - prob.R).max() < 1e-15
    assert np.abs(c(sc.X_targ) - prob.X_targ).max() == 0
    assert np.abs(c(sc.U_targ) - prob.U_targ).max() == 0
    assert (sc.sat, sc.du, sc.config.dt, sc.config.horizon, sc.config.n_steps) == (
        prob.sat, prob.du, prob.dt, prob.horizon, prob.n_steps)
    # the model [M_1 | M_u1 | M_u2], the order-1 step's operators
    exps, mats = ref.discretize(prob)
    by_exp = {tuple(e): m for e, m in zip(exps, mats)}
    A = c(sc.model.A)
    for k, e in enumerate([(0, 0), (1, 0), (0, 1)]):
        assert np.abs(A[:, 9 * k:9 * (k + 1)] - by_exp[e]).max() < 1e-14
    assert len(by_exp) == 3


def test_closed_loop_matches_the_program_on_drag_state(drag_program):
    _, out, bud = drag_program
    assert (bud.warm_iters, bud.carry_duals) == ((7, 1), True)
    assert (bud.warm_qp.rounds, bud.warm_qp.iters, bud.warm_qp.kinv, bud.warm_qp.scale) == \
        (2, 50, "gj", False)
    assert (bud.steady_qp.rounds, bud.steady_qp.iters, bud.steady_qp.kinv, bud.steady_qp.scale) \
        == (1, 19, "gj", True)
    r = ref.closed_loop(drag_state_problem(), bud, DRAG_EPS, ref.Arith("float64"), record=True)
    assert out["xs"].shape[-1] == 21
    assert float((out["xs"] - r["xs"]).abs().max()) < 1e-9
    assert float((out["us"] - r["us"]).abs().max()) < 1e-8
    assert torch.equal(out["exit_code"].long(), r["exit_code"])
    assert bool((r["exit_code"] == 0).all())


def test_unscaled_reference_does_not_match_drag_state(drag_program):
    _, out, bud = drag_program
    prob, ar = drag_state_problem(), ref.Arith("float64")
    scaled = ref.closed_loop(prob, bud, DRAG_EPS, ar, record=True)
    off = dataclasses.replace(bud, steady_qp=dataclasses.replace(bud.steady_qp, scale=False))
    plain = ref.closed_loop(prob, off, DRAG_EPS, ar, record=True)
    gap_on = float((out["xs"] - scaled["xs"]).abs().max())
    gap_off = float((out["xs"] - plain["xs"]).abs().max())
    assert gap_off >= 100 * max(gap_on, 1e-12), (gap_on, gap_off)
