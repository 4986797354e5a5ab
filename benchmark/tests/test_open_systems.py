"""CPU tests of the plain reference on open quantum systems: the dissipator
and the open plant step against the master equation on the d x d matrix,
the closed step kept as it was, the open step and the closed loop against
the program's Lindblad plant and fleet in float64, and `plant_step_gap`
failing a plant that drops its dissipator and the TF32 control.

    python -m pytest benchmark/tests/test_open_systems.py -q
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import check, drive, spec  # noqa: E402
from benchmark.reference import mpc_plain as ref  # noqa: E402

SX = np.array([[0, 1], [1, 0]], complex)
SZ = np.array([[1, 0], [0, -1]], complex)
SMINUS = np.array([[0, 1], [0, 0]], complex)
LANES_EPS = np.array([0.012, -0.004, 0.0, 0.02])


def _config(name: str) -> dict:
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


# the flagship fleet's limit of plant_step_gap, every cell's so far
STEP_LIMIT = _config("not_state")["limits"]["fleet"]["plant_step_gap"]


def _plant_problem(plant_H, plant_c, dt: float) -> ref.Problem:
    """A Problem that only plant_step and lane_drifts read."""
    return ref.Problem(model_H=plant_H, plant_H=plant_H, dt=dt, horizon=1, n_steps=1, order=1,
                       x0=None, target=None, X_targ=None, U_targ=None, Q=None, Qf=None, R=None,
                       sat=1.0, du=1.0, plant_c=tuple(plant_c))


def _random_states(g: np.random.Generator, B: int, d: int) -> np.ndarray:
    """B density matrices (B, d, d): W W^H over its trace."""
    W = g.standard_normal((B, d, d)) + 1j * g.standard_normal((B, d, d))
    rho = W @ W.conj().transpose(0, 2, 1)
    return rho / np.trace(rho, axis1=1, axis2=2)[:, None, None]


def _hermitian(g: np.random.Generator, d: int) -> np.ndarray:
    W = (g.standard_normal((d, d)) + 1j * g.standard_normal((d, d))) / np.sqrt(2 * d)
    return W + W.conj().T


def _master(H, Ls, rho):
    """-i[H, rho] + sum_L L rho L^dag - 1/2 {L^dag L, rho} on the matrix."""
    out = -1j * (H @ rho - rho @ H)
    for L in Ls:
        LdL = L.conj().T @ L
        out = out + L @ rho @ L.conj().T - 0.5 * (LdL @ rho + rho @ LdL)
    return out


def _evolve(H, Ls, rho, t: float, substeps: int = 8, terms: int = 30):
    """exp(t (master equation)) rho by its Taylor series on the matrix, in
    substeps short enough that the series converges below rounding."""
    h = t / substeps
    for _ in range(substeps):
        term = acc = rho
        for k in range(1, terms):
            term = _master(H, Ls, term) * (h / k)
            acc = acc + term
        rho = acc
    return rho


@pytest.mark.parametrize("d", [2, 4, 16])
def test_open_step_matches_the_master_equation(d):
    g = np.random.default_rng(100 + d)
    Ls = [(g.standard_normal((d, d)) + 1j * g.standard_normal((d, d))) * (0.3 / d)
          for _ in range(2)]
    rho = _random_states(g, 3, d)
    lhs = np.stack([ref.dissipator(Ls[0]) @ r.reshape(-1) for r in rho])
    rhs = np.stack([_master(np.zeros((d, d)), Ls[:1], r).reshape(-1) for r in rho])
    assert np.abs(lhs - rhs).max() < 1e-12

    H0, H1 = _hermitian(g, d), _hermitian(g, d)
    prob = _plant_problem([H0, H1], Ls, dt=0.5)
    eps = np.array([0.01, -0.02, 0.0])
    u = g.uniform(-1.0, 1.0, (3, 1))
    ar = ref.Arith("float64")
    x = torch.as_tensor(rho.reshape(3, -1))
    got = ref.plant_step(prob, ar, ref.lane_drifts(prob, ar, eps), x, torch.as_tensor(u))
    want = np.stack([_evolve(H0 * (1 + e) + uk[0] * H1, Ls, r, prob.dt).reshape(-1)
                     for e, uk, r in zip(eps, u, rho)])
    assert np.abs(got.numpy() - want).max() < 1e-12


def _closed_step_before(prob, ar, H0_lanes, x, u):
    """plant_step as it was before the reference knew collapse operators."""
    H1 = ar.c(np.stack(prob.plant_H[1:]))
    Hm = H0_lanes + torch.einsum("bj,jcd->bcd", u.to(ar.cplx), H1)
    Um = ref.expm((-1j * prob.dt) * Hm)
    d = Hm.shape[-1]
    rho = x.reshape(-1, d, d)
    return ar.mm(ar.mm(Um, rho), Um.conj().transpose(-1, -2)).reshape(x.shape)


def _closed_inputs(name: str, ar: ref.Arith, seed: int = 7, B: int = 5):
    prob = spec.reference_problem(_config(name))
    d = prob.plant_H[0].shape[0]
    g = np.random.default_rng(seed)
    x = ar.c(_random_states(g, B, d).reshape(B, -1))
    u = ar.r(g.uniform(-prob.sat, prob.sat, (B, prob.dim_u)))
    return prob, ref.lane_drifts(prob, ar, g.normal(0, 0.01, B)), x, u


@pytest.mark.parametrize("mode", ref.Arith.MODES)
@pytest.mark.parametrize("name", ["not_state", "cnot_state"])
def test_closed_step_is_unchanged(name, mode):
    ar = ref.Arith(mode)
    prob, H0, x, u = _closed_inputs(name, ar)
    assert not prob.plant_c
    assert torch.equal(ref.plant_step(prob, ar, H0, x, u), _closed_step_before(prob, ar, H0, x, u))


@pytest.mark.parametrize("name", ["not_state", "cnot_state"])
def test_open_step_without_jumps_is_the_closed_step(name):
    ar = ref.Arith("float64")
    prob, H0, x, u = _closed_inputs(name, ar)
    d = prob.plant_H[0].shape[0]
    open_prob = dataclasses.replace(prob, plant_c=(np.zeros((d, d), complex),))
    gap = ref.plant_step(open_prob, ar, H0, x, u) - ref.plant_step(prob, ar, H0, x, u)
    assert float(gap.abs().max()) < 1e-12


def _on(ops: dict, n: int = 4) -> np.ndarray:
    """The n-qubit operator with ops[k] on qubit k, the identity elsewhere."""
    out = np.eye(1, dtype=complex)
    for k in range(n):
        out = np.kron(out, ops.get(k, np.eye(2, dtype=complex)))
    return out


def lindblad_state_problem() -> ref.Problem:
    """The lindblad_state preset's problem: the flagship's (not_state's
    numbers) with amplitude damping sqrt(0.005) sigma_- in model and plant."""
    L = np.sqrt(0.005) * SMINUS
    return dataclasses.replace(spec.reference_problem(_config("not_state")),
                               model_c=(L,), plant_c=(L,))


def damped_chain4_plant() -> ref.Problem:
    """The plant of the four damped qubits of damped_chain4: H0 = 0.05 (Z1 Z2
    + Z2 Z3 + Z3 Z4), a 0.5 X drive on each qubit, sqrt(0.005) sigma_- on
    each qubit, dt 0.5."""
    H0 = 0.05 * sum(_on({k: SZ, k + 1: SZ}) for k in range(3))
    H1s = [0.5 * _on({k: SX}) for k in range(4)]
    return _plant_problem([H0] + H1s, [_on({k: np.sqrt(0.005) * SMINUS}) for k in range(4)], 0.5)


def _program_lindblad_state():
    from mpc4quantum_tpu_torch import presets

    return presets.lindblad_state(device="cpu", dtype=torch.float64)


def _program_damped_chain4():
    import chip_smoke

    return chip_smoke.damped_chain4_scenario("cpu", torch.float64)


@pytest.mark.parametrize("name", ["lindblad_state", "damped_chain4"])
def test_open_step_matches_the_program(name):
    if name == "lindblad_state":
        sc, prob = _program_lindblad_state(), lindblad_state_problem()
    else:
        sc, prob = _program_damped_chain4(), damped_chain4_plant()
    assert prob.dt == sc.config.dt
    eps = LANES_EPS[:3]
    plants = drive.lane_plants(sc.plant.to("cpu", torch.float64), eps, "cpu", torch.float64)
    d = prob.plant_H[0].shape[0]
    g = np.random.default_rng(11)
    ar = ref.Arith("float64")
    x = ar.c(_random_states(g, len(eps), d).reshape(len(eps), -1))
    u = ar.r(g.uniform(-sc.sat, sc.sat, (len(eps), prob.dim_u)))
    got = ref.plant_step(prob, ar, ref.lane_drifts(prob, ar, eps), x, u)
    want = plants.step(x, u, prob.dt, taylor_k=18, max_squarings=12)
    assert float((got - want).abs().max()) < 1e-12


def _budget(runner) -> ref.LoopBudget:
    """The reference's schedule of a program runner on boxqp_small, whose
    K^-1 is exact (Gauss-Jordan)."""
    qp = lambda p: ref.QPBudget(rounds=p.n_rounds, iters=p.max_iter, rho0=p.rho0, sigma=p.sigma,
                                alpha=p.alpha, eps_abs=p.eps_abs, eps_rel=p.eps_rel,
                                accept_abs=p.accept_abs, accept_rel=p.accept_rel, kinv="gj")
    return ref.LoopBudget(warm_iters=runner.warm_sqp_iters, warm_qp=qp(runner.config.qp_params),
                          steady_qp=qp(runner.steady_qp_params), carry_duals=runner.carry_duals,
                          step_tol=runner.config.step_tol)


def _program_fleet(eps):
    """The program's float64 CPU fleet of lindblad_state on lanes `eps`,
    recorded, and the reference's budget of its runner."""
    from mpc4quantum_tpu_torch.benchfleet import make_runner

    sc = _program_lindblad_state()
    plants = drive.lane_plants(sc.plant.to("cpu", torch.float64), eps, "cpu", torch.float64)
    runner = make_runner(sc, plants)
    out = runner.run(sc.x0, sc.model, plants, sc.X_targ, sc.U_targ, sc.Q, sc.R, sc.Qf,
                     record=True)
    return out, _budget(runner)


# lindblad_state's loop is well conditioned through step 8; from step 9 on a
# change of the start by 1e-15 moves the reference's own states by up to
# 3.1e-8 and its controls by 4.2e-8 at step 20 (the QP's control responds to
# the state with a gain near 2e4 there), so two float64 loops that round
# apart agree on the later steps to that conditioning and no closer
WELL_CONDITIONED_STEPS = 9


def test_closed_loop_matches_the_program_on_lindblad_state():
    out, bud = _program_fleet(LANES_EPS)
    assert (bud.warm_iters, bud.carry_duals) == ((7, 1), True)
    assert (bud.warm_qp.rounds, bud.warm_qp.iters, bud.steady_qp.rounds, bud.steady_qp.iters) == \
        (3, 15, 2, 15)
    r = ref.closed_loop(lindblad_state_problem(), bud, LANES_EPS, ref.Arith("float64"),
                        record=True)
    assert out["xs"].shape[-1] == 21
    gap_x, gap_u = (out["xs"] - r["xs"]).abs(), (out["us"] - r["us"]).abs()
    n = WELL_CONDITIONED_STEPS
    assert float(gap_x[..., :n + 1].max()) < 1e-10 and float(gap_u[..., :n].max()) < 1e-10
    assert float(gap_x.max()) < 1e-8 and float(gap_u.max()) < 1e-8
    assert torch.equal(out["exit_code"].long(), r["exit_code"])


@pytest.mark.parametrize("run", ["sound", "dissipator_dropped", "tf32_control"])
def test_plant_step_gap_fails_a_plant_without_its_dissipator(monkeypatch, run):
    from mpc4quantum_tpu_torch.plants.lindblad import LindbladPlant

    prob = lindblad_state_problem()
    if run == "tf32_control":
        _, bud = _program_fleet(LANES_EPS)
        out = ref.closed_loop(prob, bud, LANES_EPS, ref.Arith("tf32"), record=True)
    else:
        if run == "dissipator_dropped":
            monkeypatch.setattr(LindbladPlant, "A0", property(lambda self: self.AH0))
        out, _ = _program_fleet(LANES_EPS)
    ok = out["exit_code"] == 0
    assert bool(ok.all())
    gap = check.step_gap(prob, ref.Arith("float64"), LANES_EPS, out["xs"], out["us"], ok)
    if run == "sound":
        assert gap < 1e-10
    else:
        assert gap > STEP_LIMIT
