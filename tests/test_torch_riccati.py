"""The port's K-inverse family on the large-n route against the JAX package,
on the CPU in float64 (x64 on the JAX side) from numpy seeds: the Riccati
factorization (sequential and scanned, shifted, Jacobi-scaled, lane-batched),
the warm-started guarded Newton-Schulz inverse, the carried-inverse chain of
solve_boxqp_fixed, the solver and `boxqp_big` under the Riccati inverses on
the not_state_freq preset's first QP, the closed loop of `mpc()` on it, the
fleet entry's `kinv=` and `warm_kinv=` on JAX-drawn plants, and a
checkpointed carry that crashes and resumes.

The JAX side runs as its own CPU tests run it: the scan form of the loops
(`unroll=False`), the Pallas ADMM kernel in interpret mode where it is
compared (in float32, as the kernel runs).

Tolerances: the factorizations 1e-10 relative to the inverse's largest
entry; whole solves and inverses 1e-10 (both sides run
the same float64 arithmetic); the closed loop 1e-8 on controls and states
(the JAX loop steps its plant by Pade, the port by the Taylor expm); the
fleets 1e-8 on the final states. The carry refreshes the inverse from the
previous solve's in float64 to rounding, so the carried fleet stays within
1e-8 of the cold one, which JAX's CPU fleet (where the carry is inert: it
lives on its Pallas route) runs.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mpc4quantum_tpu import benchfleet as jbench
from mpc4quantum_tpu import presets as jpresets
from mpc4quantum_tpu.mpc.driver import mpc as jax_mpc
from mpc4quantum_tpu.ops.pallas_qp import boxqp_pallas_big
from mpc4quantum_tpu.parallel.fleet import make_scenario_batch as jax_batch
from mpc4quantum_tpu.solvers import boxqp as jb
from mpc4quantum_tpu.solvers import riccati as jr

from mpc4quantum_tpu_torch import benchfleet as tbench
from mpc4quantum_tpu_torch.kernels.admm_big import admm_big
from mpc4quantum_tpu_torch.kernels.boxqp import boxqp_big
from mpc4quantum_tpu_torch.mpc import fleet_runner
from mpc4quantum_tpu_torch.mpc.fleet_runner import mpc as port_mpc
from mpc4quantum_tpu_torch.solvers import boxqp as tb
from mpc4quantum_tpu_torch.solvers import riccati as tr

from test_riccati import _preset_qp, _random_ltv
from test_torch_learn import port_scenario

EXACT = 1e-10
LOOP = 1e-8
FLEET_B = 4
FLEET_STEPS = 12


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module: under `-n 6` each test process's
    own pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def T(a):
    return torch.tensor(np.asarray(a))


def close(t, j, tol=EXACT, rel=False):
    t = t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)
    j = np.asarray(j)
    scale = max(1.0, float(np.abs(j).max())) if rel else 1.0
    np.testing.assert_allclose(t, j, rtol=0, atol=tol * scale)


def embedded(rng, H, dx, du):
    """A random LTV horizon (test_riccati's generator, singular Q steps
    included) real-embedded on both sides."""
    A_s, B_s, _, _, Q_s, R_s, _, _ = _random_ltv(rng, H, dx, du)
    jax_side = jr.embed_ltv(A_s, B_s) + jr.embed_costs(Q_s, R_s)
    port_side = tr.embed_ltv(T(A_s), T(B_s)) + tr.embed_costs(T(Q_s), T(R_s))
    for t, j in zip(port_side, jax_side):
        close(t, j, tol=0)
    return jax_side, port_side


# ------------------------------------------------------- the factorizations

@pytest.mark.parametrize("H,dx,du", [(5, 3, 2), (10, 4, 1), (4, 3, 4), (1, 2, 2), (2, 2, 1),
                                     (50, 2, 1), (16, 9, 2)])
def test_riccati_forms_match_jax(H, dx, du):
    """riccati_kinv and riccati_kinv_pscan on the Rr + shift data of
    test_riccati.py at the shapes of its exactness and scan tests
    (non-power-of-two horizons, singular Q steps), and the shifted form
    with Jacobi weights, scanned and not, at the first of them."""
    rng = np.random.default_rng(H * 100 + dx * 10 + du)
    (Ar, Br, Qr, Rr), (tAr, tBr, tQr, tRr) = embedded(rng, H, dx, du)
    Rt = Rr + 0.41 * jnp.eye(du)[None]
    tRt = tRr + 0.41 * torch.eye(du, dtype=torch.float64)
    ref = np.asarray(jr.riccati_kinv(Ar, Br, Qr, Rt))
    close(tr.riccati_kinv(tAr, tBr, tQr, tRt), ref, rel=True)
    close(tr.riccati_kinv_pscan(tAr, tBr, tQr, tRt), np.asarray(
        jax.jit(jr.riccati_kinv_pscan)(Ar, Br, Qr, Rt)), rel=True)
    if (H, dx, du) != (5, 3, 2):
        return
    d = rng.uniform(0.5, 2.0, H * du)
    shifted = jax.jit(jr.riccati_kinv_shifted, static_argnames="pscan")
    for pscan in (False, True):
        ref = shifted(Ar, Br, Qr, Rr, 0.7, 1e-6, d=jnp.asarray(d), pscan=pscan)
        close(tr.riccati_kinv_shifted(tAr, tBr, tQr, tRr, 0.7, 1e-6, d=T(d), pscan=pscan),
              ref, rel=True)


def test_associative_scan_keeps_time_order():
    """The suffix scan hands `combine` its operands earlier first, as the
    prefix scan does: composed affine maps x -> M x + b (which do not
    commute) at a non-power-of-two length."""
    rng = np.random.default_rng(3)
    L = 7
    M = torch.tensor(rng.normal(size=(L, 3, 3)))
    b = torch.tensor(rng.normal(size=(L, 3, 1)))
    comp = lambda e1, e2: (e2[0] @ e1[0], e2[0] @ e1[1] + e2[1])
    pre = tr.associative_scan(comp, (M, b))
    suf = tr.associative_scan(comp, (M, b), reverse=True)
    for k in range(L):
        acc = (torch.eye(3, dtype=M.dtype), torch.zeros(3, 1, dtype=M.dtype))
        for j in range(k + 1):
            acc = comp(acc, (M[j], b[j]))
        close(pre[0][k], acc[0].numpy(), rel=True)
        close(pre[1][k], acc[1].numpy(), rel=True)
        acc = (torch.eye(3, dtype=M.dtype), torch.zeros(3, 1, dtype=M.dtype))
        for j in range(k, L):
            acc = comp(acc, (M[j], b[j]))
        close(suf[0][k], acc[0].numpy(), rel=True)
        close(suf[1][k], acc[1].numpy(), rel=True)


@pytest.mark.parametrize("pscan", [False, True])
def test_riccati_batch_matches_jax(pscan):
    """Lane-batched, with per-lane rho and Jacobi weights and shared costs,
    against JAX's vmapped batch."""
    rng = np.random.default_rng(1)
    H, dx, du, B = 6, 3, 2, 5
    lanes = [_random_ltv(rng, H, dx, du) for _ in range(B)]
    Ar, Br = (np.stack(a) for a in zip(*[jr.embed_ltv(l[0], l[1]) for l in lanes]))
    Qr, Rr = jr.embed_costs(lanes[0][4], lanes[0][5])
    rho = rng.uniform(0.05, 2.0, B)
    d = rng.uniform(0.5, 2.0, (B, H * du))
    ref = jax.jit(jr.riccati_kinv_batch, static_argnames="pscan")(
        jnp.asarray(Ar), jnp.asarray(Br), Qr, Rr, jnp.asarray(rho), 1e-6, d=jnp.asarray(d),
        pscan=pscan)
    ours = tr.riccati_kinv_batch(T(Ar), T(Br), T(Qr), T(Rr), T(rho), 1e-6, d=T(d),
                                 pscan=pscan)
    assert ours.shape == (B, H * du, H * du)
    close(ours, ref, rel=True)
    with pytest.raises(ValueError, match="lane axis"):
        tr.riccati_kinv_batch(T(Ar), T(Br), T(Qr), T(Rr), T(rho[:2]), 1e-6)


# ------------------------------------------------- warm-started inverses

def spd_batch(B, n, seed):
    """test_warm_kinv's SPD batch, in float64."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, n, n))
    P = M @ np.swapaxes(M, 1, 2) / n + 0.1 * np.eye(n)
    return M, P, rng.normal(size=(B, n)), -np.ones((B, n)), np.ones((B, n))


def test_ns_inverse_warm_start_and_guard_match_jax():
    """A warm start from a nearby inverse, and a garbage X0 on element 0
    only, which that element's guard sends back to the cold init."""
    M, P, _, _, _ = spd_batch(3, 20, seed=2)
    K = P + 0.2 * np.eye(20)
    Xc = np.asarray(jb.ns_inverse(jnp.asarray(K), iters=40))
    close(tb.ns_inverse(T(K), iters=40), Xc)
    Kp = K + 0.004 * (M + np.swapaxes(M, 1, 2)) / 20
    X0 = Xc.copy()
    X0[0] = 100.0 * np.eye(20)
    for guard in (0.5, 0.9):
        ref = jb.ns_inverse(jnp.asarray(Kp), iters=8, X0=jnp.asarray(X0), guard=guard)
        close(tb.ns_inverse(T(Kp), iters=8, X0=T(X0), guard=guard), ref)
    cold = tb.ns_inverse(T(Kp), iters=8)
    warm = tb.ns_inverse(T(Kp), iters=8, X0=T(X0))
    torch.testing.assert_close(warm[0], cold[0], rtol=0, atol=0)
    assert float((torch.eye(20, dtype=torch.float64) - T(Kp[1:]) @ warm[1:]).abs().max()) < 1e-10


def test_kinv0_chain_matches_jax():
    """Three drifting solves, each from the previous one's inverse (and
    dual and rho), against the JAX chain: z, y, rho and K^-1; then a
    garbage carry, whose lanes the guard sends cold and reports."""
    M, P, q, lb, ub = spd_batch(6, 24, seed=3)
    params_j = jb.BoxQPParams(max_iter=20, n_rounds=2, ns_iters=20, unroll=False, scale=True)
    params_t = tb.BoxQPParams(max_iter=20, n_rounds=2, ns_iters=20, scale=True)
    jsolve = jax.jit(jax.vmap(lambda P, q, lb, ub, y0, r0, k0: jb.solve_boxqp_fixed(
        P, q, lb, ub, params=params_j, y0=y0, rho0=r0, kinv0=k0)))
    r = jax.vmap(lambda *a: jb.solve_boxqp_fixed(*a, params=params_j))(
        *map(jnp.asarray, (P, q, lb, ub)))
    ours = tb.solve_boxqp_fixed(*map(T, (P, q, lb, ub)), params=params_t)
    close(ours.kinv, r.kinv)
    assert ours.guard_cold is None
    rng = np.random.default_rng(4)
    drift = 0.01 * (M + np.swapaxes(M, 1, 2)) / 24
    for step in range(3):
        P = P + drift
        q = q + 0.01 * rng.normal(size=q.shape)
        r = jsolve(*map(jnp.asarray, (P, q, lb, ub)), r.y, r.rho, r.kinv)
        ours = tb.solve_boxqp_fixed(*map(T, (P, q, lb, ub)), y0=ours.y, rho0=ours.aux.rho,
                                    kinv0=ours.kinv, params=params_t)
        for o, j in ((ours.z, r.x), (ours.y, r.y), (ours.aux.rho, r.rho), (ours.kinv, r.kinv)):
            close(o, j)
        assert bool(r.converged.all()) and not bool(ours.guard_cold.any()), step
    bad = 100.0 * np.broadcast_to(np.eye(24), (6, 24, 24))
    r = jsolve(*map(jnp.asarray, (P, q, lb, ub)), r.y, r.rho, jnp.asarray(bad))
    ours = tb.solve_boxqp_fixed(*map(T, (P, q, lb, ub)), y0=ours.y, rho0=ours.aux.rho,
                                kinv0=T(bad), params=params_t)
    close(ours.z, r.x)
    close(ours.kinv, r.kinv)
    assert bool(ours.guard_cold.all())


# ---------------------------------------- solves on the preset's first QP

@pytest.fixture(scope="module")
def preset_qp():
    """not_state_freq's first QP (n = 50) and its LQR data, as numpy."""
    P, q, lb, ub, lqr = _preset_qp()
    return tuple(np.asarray(a) for a in (P, q, lb, ub)), tuple(np.asarray(a) for a in lqr)


@pytest.mark.parametrize("scale", [False, True], ids=["unscaled", "scaled"])
@pytest.mark.parametrize("kinv", ["riccati", "riccati_pscan"])
def test_riccati_solves_match_jax(preset_qp, kinv, scale):
    """solve_boxqp_fixed (one lane) and boxqp_big's plain route (two lanes
    of the same QP) under the Riccati inverses, with the rho rebalance of a
    second round, against the JAX solve_boxqp_fixed; and against the
    converged Newton-Schulz solve, as test_riccati.py holds JAX's."""
    (P, q, lb, ub), lqr = preset_qp
    params_j = jb.BoxQPParams(max_iter=40, n_rounds=2, unroll=False, scale=scale,
                              ns_iters=30, kinv=kinv, ns_polish=1)
    ref = jax.jit(lambda *a, lqr_data: jb.solve_boxqp_fixed(*a, params=params_j,
                                                            lqr_data=lqr_data))(
        *map(jnp.asarray, (P, q, lb, ub)), lqr_data=tuple(map(jnp.asarray, lqr)))
    assert bool(ref.converged)
    lanes = lambda a, k=1: T(np.broadcast_to(a, (k,) + a.shape).copy())
    lqr_t = (lanes(lqr[0]), lanes(lqr[1]), T(lqr[2]), T(lqr[3]))
    params_t = tb.BoxQPParams(max_iter=40, n_rounds=2, scale=scale, ns_iters=30, kinv=kinv)
    ours = tb.solve_boxqp_fixed(lanes(P), lanes(q), lanes(lb), lanes(ub), params=params_t,
                                lqr_data=lqr_t)
    for o, j in ((ours.z[0], ref.x), (ours.y[0], ref.y), (ours.aux.rho[0], ref.rho),
                 (ours.kinv[0], ref.kinv)):
        close(o, j, rel=True)
    lqr_2 = (lanes(lqr[0], 2), lanes(lqr[1], 2), T(lqr[2]), T(lqr[3]))
    admm_big.launches = 0
    big = boxqp_big(lanes(P, 2), lanes(q, 2), lanes(lb, 2), lanes(ub, 2), iters=40, rounds=2,
                    scale=scale, kinv_method=kinv, lqr_data=lqr_2)
    assert admm_big.launches == 0
    for o, j in ((big.z, ref.x), (big.y, ref.y), (big.kinv, ref.kinv)):
        close(o, np.broadcast_to(np.asarray(j), o.shape), rel=True)
    ns = tb.solve_boxqp_fixed(lanes(P), lanes(q), lanes(lb), lanes(ub),
                              params=dataclasses.replace(params_t, kinv="ns"))
    close(ours.z, ns.z.numpy(), tol=1e-7)


def test_boxqp_big_riccati_matches_the_pallas_kernel(preset_qp):
    """boxqp_big under the Riccati inverse against boxqp_pallas_big(lqr_data=)
    in interpret mode, in float32 as the kernels run, scaled and not."""
    (P, q, lb, ub), lqr = preset_qp
    B = 3
    lanes = lambda a: np.broadcast_to(a, (B,) + a.shape).astype(np.float32)
    args = [lanes(a) for a in (P, q, lb, ub)]
    lqr_b = (lanes(lqr[0]), lanes(lqr[1]), lqr[2].astype(np.float32),
             lqr[3].astype(np.float32))
    for scale in (False, True):
        x_j = boxqp_pallas_big(*map(jnp.asarray, args), iters=25, rounds=2, interpret=True,
                               scale=scale, lqr_data=tuple(map(jnp.asarray, lqr_b)),
                               ns_polish=1, lqr_unroll=False)
        ours = boxqp_big(*map(torch.tensor, args), iters=25, rounds=2, scale=scale,
                         kinv_method="riccati", lqr_data=tuple(map(torch.tensor, lqr_b)))
        close(ours.z, x_j, tol=2e-5, rel=True)


# ------------------------------------------------------------- closed loop

def test_mpc_riccati_closed_loop_matches_jax():
    """`mpc()` on not_state_freq cut to 20 steps on the kernel route with
    kinv="riccati" (n = 50: boxqp_big), against the JAX mpc() whose
    quad_program factors the same LTV data (test_riccati.py)."""
    sc_j = jpresets.not_state_freq()
    cfg_j = dataclasses.replace(sc_j.config, n_steps=20, qp_backend="ns",
                                qp_params=jb.BoxQPParams(max_iter=40, n_rounds=2, unroll=False,
                                                         kinv="riccati", ns_polish=1))
    args = sc_j.mpc_args()
    args["config"] = cfg_j
    res_j = jax_mpc(**args)
    plants_j, _ = jax_batch(jax.random.PRNGKey(0), sc_j.plant, 1, detune_scale=0.0)
    sc, _ = port_scenario(sc_j, plants_j, torch.float64)
    cfg = dataclasses.replace(sc.config, n_steps=20, qp_backend="ns",
                              qp_params=tb.BoxQPParams(max_iter=40, n_rounds=2, kinv="riccati"))
    res = port_mpc(sc.x0, sc.model, sc.plant, sc.X_targ, sc.U_targ, sc.Q, sc.R, sc.Qf, cfg,
                   sc.sat, sc.du, exit_condition=sc.exit_condition)
    assert int(res.exit_code) == int(res_j.exit_code) == 0
    close(res.us, res_j.us, tol=LOOP)
    close(res.xs, res_j.xs, tol=LOOP)
    np.testing.assert_array_equal(res.sqp_iters.numpy(), np.asarray(res_j.sqp_iters))


def test_mpc_ignores_qp_warm_kinv():
    """The JAX package's mpc() has no K-inverse carry (its MPCConfig only
    declares qp_warm_kinv), and neither has the port's: on not_state_freq's
    kernel route (n = 50, Newton-Schulz, 10 steady solves) mpc() with the
    field set returns the rollout without it, bit for bit. The fleet
    runner's carry is test_fleet_kinv_options_match_jax's."""
    sc_j = jpresets.not_state_freq()
    plants_j, _ = jax_batch(jax.random.PRNGKey(0), sc_j.plant, 1, detune_scale=0.0)
    sc, _ = port_scenario(sc_j, plants_j, torch.float64)
    cfg = dataclasses.replace(sc.config, n_steps=12, qp_backend="ns")
    runs = [port_mpc(sc.x0, sc.model, sc.plant, sc.X_targ, sc.U_targ, sc.Q, sc.R, sc.Qf,
                     dataclasses.replace(cfg, qp_warm_kinv=warm), sc.sat, sc.du,
                     exit_condition=sc.exit_condition) for warm in (False, True)]
    for name in ("us", "xs", "sqp_iters", "exit_code"):
        assert torch.equal(getattr(runs[0], name), getattr(runs[1], name)), name


# ------------------------------------------------------------------ fleets

@pytest.fixture(scope="module")
def freq_reference():
    """The JAX fleet of not_state_freq cut to 12 steps on 4 JAX-drawn plants
    (~15 s), on its CPU route with the Riccati inverse."""
    sc = jpresets.not_state_freq()
    sc = dataclasses.replace(sc, config=dataclasses.replace(
        sc.config, n_steps=FLEET_STEPS, qp_params=sc.config.qp_params.replace(unroll=False)))
    plants, keys = jax_batch(jax.random.PRNGKey(1), sc.plant, FLEET_B, detune_scale=0.01)
    metrics, out = jbench.run_hostloop_fleet(sc, FLEET_B, cpu=True, kinv="riccati",
                                             _plants=plants, _keys=keys)
    port_sc, port_plants = port_scenario(sc, plants, torch.float64)
    return metrics, out, port_sc, port_plants


@pytest.mark.parametrize("kw", [dict(kinv="riccati"), dict(kinv="riccati_pscan"),
                                dict(warm_kinv=True), dict(kinv="riccati", warm_kinv=True)],
                         ids=["riccati", "riccati_pscan", "warm_kinv", "riccati_warm_kinv"])
def test_fleet_kinv_options_match_jax(freq_reference, kw):
    """run_hostloop_fleet with the K-inverse forced and with the steady
    carry: the final states of the JAX Riccati fleet, its exit codes and
    metrics. The carry warm-starts every steady solve but the cold entries
    (step 2 and the measurement steps 5 and 10: 10 steady solves, 7 warm),
    and no lane falls back; under the Riccati inverse the carry is moot."""
    m_j, out_j, sc, plants = freq_reference
    m, out = tbench.run_hostloop_fleet(sc, FLEET_B, plants=plants, **kw)
    close(out["final_x"], out_j["final_x"], tol=LOOP)
    np.testing.assert_array_equal(out["exit_code"].numpy(), out_j["exit_code"])
    for key in ("fidelity_mean", "fidelity_min", "completed_frac", "qp_fail_frac",
                "steady_budget", "warm_budget", "qp_scale", "warm_duals"):
        assert m[key] == m_j[key], key
    assert m["warm_kinv"] == bool(kw.get("warm_kinv", False))
    assert m["kinv"] == kw.get("kinv", "ns")
    carried = kw.get("warm_kinv") and "kinv" not in kw
    assert (m["kinv_warm_solves"], m["kinv_guard_cold"]) == ((7, 0) if carried else (0, 0))


def test_carry_checkpoint_resumes_exactly(tmp_path):
    """A carried-inverse fleet that crashes after step 7 and resumes from
    its checkpoint (the carry and its counts are loop state) equals the
    uninterrupted run, record included."""
    from mpc4quantum_tpu_torch import presets
    from mpc4quantum_tpu_torch.parallel.fleet import make_scenario_batch

    sc = presets.not_state_freq(device="cpu")
    sc = dataclasses.replace(sc, config=dataclasses.replace(sc.config, n_steps=FLEET_STEPS))
    plants = make_scenario_batch(sc.plant, 2)
    runner = tbench.make_runner(sc, plants, warm_kinv=True)
    assert runner.carry_kinv
    args = (sc.x0, sc.model, plants, sc.X_targ, sc.U_targ, sc.Q, sc.R, sc.Qf)
    full = runner.run(*args, record=True)
    full_counts = runner.kinv_counts.clone()
    path = str(tmp_path / "carry.npz")
    orig, calls = fleet_runner.advance, {"n": 0}

    def crashing(*a, **k):
        calls["n"] += 1
        if calls["n"] == 8:
            raise RuntimeError("simulated crash")
        return orig(*a, **k)

    fleet_runner.advance = crashing
    try:
        with pytest.raises(RuntimeError, match="simulated crash"):
            runner.run(*args, record=True, checkpoint_path=path, checkpoint_every=3)
    finally:
        fleet_runner.advance = orig
    assert os.path.exists(path)
    resumed = runner.run(*args, record=True, checkpoint_path=path, checkpoint_every=3)
    for key in ("final_x", "exit_code", "xs", "us", "objs", "sqp_iters", "n_valid"):
        assert torch.equal(resumed[key], full[key]), key
    assert torch.equal(runner.kinv_counts, full_counts)
    assert full_counts.tolist() == [7, 0] and not os.path.exists(path)


@pytest.mark.parametrize("name,kinv", [("not_state_freq", None), ("drag_state", "ns")])
def test_carry_fallback_is_counted_and_fails_the_lanes(name, kinv):
    """The carry's known failure on these fleets, which the JAX package's
    own chip run of it shows too (experiments/logs/r4_warm_kinv.log: every
    freq and drag lane lost): over the whole run the carried inverse leaves
    the guard's contraction region at a drift spike (freq) or as P is
    rebuilt (drag), the guard sends the lanes to the cold init at the
    refresh budget, their QPs fail and the lanes end with code 2. The
    fallbacks are counted, not hidden; without the carry the same lanes
    complete."""
    from mpc4quantum_tpu_torch import presets
    from mpc4quantum_tpu_torch.parallel.fleet import make_scenario_batch

    sc = presets.PRESETS[name](device="cpu")
    plants = make_scenario_batch(sc.plant, 2)
    m, out = tbench.run_hostloop_fleet(sc, 2, plants=plants, kinv=kinv, warm_kinv=True)
    assert m["kinv_warm_solves"] > 0 and m["kinv_guard_cold"] >= 2
    assert m["qp_fail_frac"] == 1.0 and out["exit_code"].tolist() == [2, 2]
    m0, _ = tbench.run_hostloop_fleet(sc, 2, plants=plants, kinv=kinv)
    assert m0["completed_frac"] == 1.0 and m0["qp_fail_frac"] == 0.0
