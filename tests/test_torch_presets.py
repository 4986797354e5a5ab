"""The port's `not_gate` and `lindblad_state` slices against the JAX package,
on the CPU in x64: the Lindblad generators, the synthesis and Lindblad
plants, the lane batches, the exit condition in the advance, the presets
and both whole fleets.

Tolerances: 1e-12 where port and reference run the same algorithm on
values of order one (generators, lifts, steps with equal expm forms);
1e-9 against the Pade steps and where the Lindblad step's expm forms differ
by design (the reference's XLA step squares once, the port's per-lane count
is 0 at these norms: both exact to Taylor-12 truncation, ~3e-11 at the
bound 0.889). Whole fleets: float64 final states within 1e-9 (not_gate,
equal expm forms) and 1e-8 (lindblad), exit codes and the rounded metrics
equal; a float32 port run within 1e-4 of the reference's per-lane fidelity
with equal exit codes, except lindblad: its closed loop branches under
float32 rounding from step 9 on, when the controls leave the box edge (the
JAX package's own float32 run ends up to 9.0e-3 from its x64 run on these
lanes, the port's 4.5e-3), so its full-length bound is 1e-2 and an 8-step
float32 run, before the branching, is held to 1e-6.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mpc4quantum_tpu import presets as jpresets
from mpc4quantum_tpu.benchfleet import run_hostloop_fleet as jax_fleet
from mpc4quantum_tpu.mpc import driver as jdrv
from mpc4quantum_tpu.ops import liouville as jliou
from mpc4quantum_tpu.parallel.fleet import make_scenario_batch as jax_batch
from mpc4quantum_tpu.plants import lindblad as jlind, quantum as jq, synthesis as jsyn

from mpc4quantum_tpu_torch import presets as tpresets
from mpc4quantum_tpu_torch.benchfleet import expm_budget_for, fleet_fidelity, run_hostloop_fleet
from mpc4quantum_tpu_torch.convert import plant_from_numpy, scenario_from_numpy
from mpc4quantum_tpu_torch.kernels.admm_big import admm_big
from mpc4quantum_tpu_torch.kernels.boxqp import boxqp_small
from mpc4quantum_tpu_torch.kernels.expm import expm_small
from mpc4quantum_tpu_torch.mpc import driver as tdrv
from mpc4quantum_tpu_torch.ops import liouville as tliou
from mpc4quantum_tpu_torch.parallel.fleet import make_scenario_batch
from mpc4quantum_tpu_torch.plants.lindblad import LindbladPlant, lindblad_norm_bound
from mpc4quantum_tpu_torch.plants.quantum import taylor_norm_bound
from mpc4quantum_tpu_torch.plants.synthesis import SynthesisPlant, lift_unitary

B = 4
EXACT = 1e-12
TAYLOR = 1e-9
PLANT_FIELDS = ("H0", "H1s", "AH0", "AD", "A1s", "sigma")
# preset: (constructor arguments, expm budget, float64 final-state bound,
# float32 fidelity bound)
FLEETS = {"not_gate": (dict(n_steps=90), (12, 0), 1e-9, 1e-4),
          "lindblad_state": ({}, (12, 1), 1e-8, 1e-2)}
# the reference not_gate's exit threshold on the process cost
NOT_GATE_EXIT = 1e-2


def close(t, j, tol=EXACT):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=0, atol=tol)


def crandn(rng, *shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def hermitian(rng, *shape):
    G = crandn(rng, *shape)
    return 0.5 * (G + np.conj(np.swapaxes(G, -1, -2)))


def plant_fields(p) -> dict:
    return {k: np.asarray(getattr(p, k)) for k in PLANT_FIELDS if hasattr(p, k)}


def port_scenario(sc, plants, dtype):
    """The JAX scenario and lane batch carried across as numpy."""
    c, qp = sc.config, sc.config.qp_params
    config = dict(horizon=c.horizon, n_steps=c.n_steps, dt=c.dt, dim_u=c.dim_u, order=c.order,
                  measure_freq=c.measure_freq, warm_start=c.warm_start, step_tol=c.step_tol,
                  qp_params=dict(rho0=qp.rho0, sigma=qp.sigma, alpha=qp.alpha,
                                 eps_abs=qp.eps_abs, eps_rel=qp.eps_rel, max_iter=qp.max_iter,
                                 n_rounds=qp.n_rounds, accept_abs=qp.accept_abs,
                                 accept_rel=qp.accept_rel, ns_iters=qp.ns_iters,
                                 kinv=qp.kinv, scale=qp.scale))
    a = np.asarray
    exit_below = (None if sc.exit_condition is None
                  else (a(sc.target_state), NOT_GATE_EXIT))
    return scenario_from_numpy(
        sc.name, x0=a(sc.x0), A=a(sc.model.A), X_targ=a(sc.X_targ), U_targ=a(sc.U_targ),
        Q=a(sc.Q), R=a(sc.R), Qf=a(sc.Qf), sat=sc.sat, du=sc.du,
        target_state=a(sc.target_state), config=config, plant=plant_fields(sc.plant),
        plants=plant_fields(plants), exit_below=exit_below, device="cpu", dtype=dtype)


# ---------------------------------------------------------------- generators

@pytest.mark.parametrize("d", [2, 3])
def test_lindblad_generators_match_jax(d):
    rng = np.random.default_rng(d)
    H, L1, L2 = hermitian(rng, d, d), crandn(rng, d, d), crandn(rng, d, d) * 0.3
    close(tliou.liouville_generator(H), jliou.liouville_generator(H))
    close(tliou.dissipator(L1), jliou.dissipator(L1))
    close(tliou.lindblad_generator(H, [L1, L2]), jliou.lindblad_generator(H, [L1, L2]))
    # the matrix-unit vectorize_me is the same generator
    basis = [np.eye(d * d)[k].reshape(d, d) for k in range(d * d)]
    close(tliou.liouville_generator(H), tliou.vectorize_me(H, basis))


# -------------------------------------------------------------------- plants

def test_lift_unitary_matches_jax():
    rng = np.random.default_rng(1)
    U = crandn(rng, 3, 4)
    close(lift_unitary(torch.tensor(U)), jax.vmap(jsyn.lift_unitary)(jnp.asarray(U)))


def test_synthesis_step_matches_jax():
    rng = np.random.default_rng(2)
    H0, H1 = hermitian(rng, B, 2, 2) * 0.3, 0.5 * np.eye(2)[::-1]
    H1s = np.broadcast_to(H1, (B, 1, 2, 2)).astype(complex)
    p = crandn(rng, B, 16)
    u = rng.uniform(-1, 1, size=(B, 1))
    dt = 0.05
    tp = SynthesisPlant(torch.tensor(H0), torch.tensor(H1s))
    jp = jsyn.SynthesisPlant.create(H0[0], [H1])
    jb = jp.replace(H0=jnp.asarray(H0), H1s=jnp.asarray(H1s))
    out_t = tp.step(torch.tensor(p), torch.tensor(u), dt, 12, 0)
    for fn, tol in ((functools.partial(jsyn.synthesis_step_taylor, fixed_squarings=0, order=12),
                     EXACT), (jsyn.synthesis_step, TAYLOR)):
        out_j = jax.vmap(lambda h0, h1, pp, uu: fn(jp.replace(H0=h0, H1s=h1), pp, uu, dt))(
            jb.H0, jb.H1s, jnp.asarray(p), jnp.asarray(u))
        close(out_t, out_j, tol)
    assert taylor_norm_bound(tp, dt, 1.0) == pytest.approx(
        jq.taylor_norm_bound(jb, dt, 1.0), rel=1e-14)


def test_lindblad_step_matches_jax():
    """At the preset's norms (up to the bound 0.889) the port's (12, 1) form
    takes 0 squarings per lane, the reference's XLA step 1."""
    sc = jpresets.lindblad_state()
    jb, _ = jax_batch(jax.random.PRNGKey(1), sc.plant, B)
    tp = plant_from_numpy(plant_fields(jb))
    assert isinstance(tp, LindbladPlant)
    rng = np.random.default_rng(3)
    x = crandn(rng, B, 4)
    u = rng.uniform(-sc.sat, sc.sat, size=(B, 1))
    u[0] = sc.sat  # a lane at the edge of the box
    out_t = tp.step(torch.tensor(x), torch.tensor(u), 1.0, 12, 1)
    step = lambda fn: jax.vmap(lambda p, xx, uu: fn(p, xx, uu, 1.0))(jb, jnp.asarray(x),
                                                                      jnp.asarray(u))
    close(out_t, step(functools.partial(jlind.lindblad_step_taylor, fixed_squarings=1,
                                        order=12)), TAYLOR)
    close(out_t, step(jlind.lindblad_step), TAYLOR)
    # the same form on both sides: Taylor 12 without squaring, at half the norm
    out_t0 = tp.step(torch.tensor(x), torch.tensor(u), 0.5, 12, 0)
    close(out_t0, jax.vmap(lambda p, xx, uu: jlind.lindblad_step_taylor(
        p, xx, uu, 0.5, fixed_squarings=0, order=12))(jb, jnp.asarray(x), jnp.asarray(u)))
    assert lindblad_norm_bound(tp, 1.0, sc.sat) == pytest.approx(
        jlind.lindblad_norm_bound(jb, 1.0, sc.sat), rel=1e-14)


def test_scenario_batch_scales_the_coherent_drift():
    g = lambda: torch.Generator().manual_seed(5)
    base = tpresets.lindblad_state(device="cpu", dtype=torch.float64).plant
    lanes = make_scenario_batch(base, 16, generator=g())
    flagship = tpresets.not_state(device="cpu", dtype=torch.float64).plant
    eps = make_scenario_batch(flagship, 16, generator=g()).H0[:, 0, 0] / flagship.H0[0, 0] - 1
    assert 0.002 < float(eps.real.std()) < 0.02
    close(lanes.AH0, base.AH0 * (1 + eps)[:, None, None])
    close(lanes.AD, base.AD.expand(16, -1, -1))
    close(lanes.A1s, base.A1s.expand(16, -1, -1, -1))
    assert lanes.sigma.shape == (16,)
    rng = np.random.default_rng(6)
    syn = SynthesisPlant(torch.tensor(hermitian(rng, 2, 2)), torch.tensor(crandn(rng, 1, 2, 2)))
    syn_lanes = make_scenario_batch(syn, 16, generator=g(), dtype=torch.float32)
    assert isinstance(syn_lanes, SynthesisPlant) and syn_lanes.dtype == torch.complex64
    close(syn_lanes.H0.to(torch.complex128), syn.H0 * (1 + eps)[:, None, None], 1e-6)
    close(syn_lanes.H1s.to(torch.complex128), syn.H1s.expand(16, -1, -1, -1), 1e-7)


@pytest.mark.parametrize("name", sorted(FLEETS))
def test_norm_bounds_and_expm_budget_match_jax(name):
    kw, budget = FLEETS[name][:2]
    sc = getattr(jpresets, name)(**kw)
    jb, _ = jax_batch(jax.random.PRNGKey(1), sc.plant, 1024)
    tb = plant_from_numpy(plant_fields(jb))
    jax_bound = (jlind.lindblad_norm_bound if name == "lindblad_state"
                 else jq.taylor_norm_bound)(jb, sc.config.dt, sc.sat)
    assert tb.norm_bound(sc.config.dt, sc.sat) == pytest.approx(jax_bound, rel=1e-14)
    assert expm_budget_for(tb, sc.config.dt, sc.sat) == budget


# ------------------------------------------------------------------ presets

@pytest.mark.parametrize("name", sorted(FLEETS))
def test_preset_matches_jax(name):
    kw = FLEETS[name][0]
    sc_j = getattr(jpresets, name)(**kw)
    sc_t = tpresets.PRESETS[name](device="cpu", dtype=torch.float64, **kw)
    for f in ("x0", "X_targ", "U_targ", "Q", "R", "Qf", "target_state"):
        close(getattr(sc_t, f), getattr(sc_j, f))
    close(sc_t.model.A, sc_j.model.A)
    for k, v in plant_fields(sc_j.plant).items():
        close(getattr(sc_t.plant, k), v)
    assert type(sc_t.plant) is type(plant_from_numpy(plant_fields(sc_j.plant)))
    assert (sc_t.sat, sc_t.du) == (sc_j.sat, sc_j.du)
    for f in ("horizon", "n_steps", "dt", "dim_u", "order", "measure_freq", "warm_start",
              "step_tol"):
        assert getattr(sc_t.config, f) == getattr(sc_j.config, f)
    assert (sc_t.exit_condition is None) == (sc_j.exit_condition is None)


def test_distance_exit_matches_jax():
    """The port's not_gate condition against the reference's closure, on
    lanes on both sides of the threshold; only the current state counts."""
    sc_j, sc_t = jpresets.not_gate(), tpresets.not_gate(device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(7)
    pf = np.asarray(sc_j.target_state)
    scale = np.sqrt(NOT_GATE_EXIT) * np.array([0.5, 0.9, 0.99, 1.01, 1.5, 3.0])
    d = crandn(rng, 6, 16)
    x_cur = pf + d / np.linalg.norm(d, axis=1, keepdims=True) * scale[:, None]
    x_next = crandn(rng, 6, 16)
    u = rng.normal(size=(6, 1))
    got = sc_t.exit_condition(torch.tensor(x_next), torch.tensor(x_cur), torch.tensor(u))
    want = jax.vmap(sc_j.exit_condition)(jnp.asarray(x_next), jnp.asarray(x_cur), jnp.asarray(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [True, True, True, False, False, False])
    # a next state on the target does not fire it
    far = torch.tensor(x_cur[3:])
    assert not sc_t.exit_condition(torch.tensor(pf).expand(3, -1), far, u[3:]).any()


# -------------------------------------------------------------- the advance

def test_advance_exit_condition_matches_jax():
    """Exit bookkeeping on a hand-made not_gate batch, against the JAX
    make_mpc_step(...).advance with the reference's exit condition. The plant
    step lands every lane on the target, so only a condition that reads the
    current state tells the lanes apart:
      0 current state near the target         -> code 1, done;
      1 current state far (next on target)    -> code 0, running;
      2 near, but its step failed (code 2)    -> code 2, done;
      3 done earlier with code 1              -> frozen, code 1;
      4 far, step failed with code 3          -> code 3, done;
      5 near, done earlier with code 2        -> frozen, code 2."""
    sc_j, sc_t = jpresets.not_gate(), tpresets.not_gate(device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(8)
    n, H, dim_x = 6, sc_t.config.horizon, 16
    pf = np.asarray(sc_j.target_state)
    near = pf + 0.01 * crandn(rng, dim_x)
    x_cur = crandn(rng, n, dim_x)
    x_cur[[0, 2, 5]] = near
    carry = (x_cur, crandn(rng, n, dim_x), crandn(rng, n, dim_x, H + 1),
             rng.normal(size=(n, 1, H)), rng.normal(size=(n, 1)),
             np.array([0, 0, 0, 1, 0, 2], np.int32),
             np.array([False, False, False, True, False, True]))
    s = (crandn(rng, n, dim_x, H + 1), rng.normal(size=(n, 1, H)),
         crandn(rng, n, dim_x, H + 1), rng.normal(size=(n, 1, H)), rng.uniform(0, 1, n),
         np.full(n, 3, np.int32), np.ones(n, bool), np.array([0, 0, 2, 0, 3, 0], np.int32),
         rng.normal(size=(n, H)), rng.uniform(0.1, 1, n))

    jplants, keys = jax_batch(jax.random.PRNGKey(0), sc_j.plant, n)
    Q_s = jnp.concatenate([jnp.tile(sc_j.Q[None], (H, 1, 1)), sc_j.Qf[None]])
    R_s = jnp.tile(sc_j.R[None], (H, 1, 1))
    identity = lambda plant, z: z
    step_fn = jdrv.make_mpc_step(sc_j.config, Q_s, R_s, sc_j.sat, sc_j.du,
                                 plant_step_fn=lambda plant, x, u, dt: jnp.asarray(pf),
                                 lift_fn=identity, proj_fn=identity,
                                 exit_condition=sc_j.exit_condition)
    carry_j = tuple(map(jnp.asarray, carry[:5])) + (keys,) + tuple(map(jnp.asarray, carry[5:]))
    new_j, _, _ = jax.vmap(lambda c, si, p: step_fn.advance(
        c, si, 4, p, sc_j.model, sc_j.X_targ, sc_j.U_targ))(
        carry_j, tuple(map(jnp.asarray, s)), jplants)

    plants = plant_from_numpy(plant_fields(jplants))
    carry_t = tdrv.Carry(*map(torch.tensor, carry))
    ctx = tdrv.context(carry_t, 4, sc_t.config, sc_t.X_targ, sc_t.U_targ, plants)
    bmodel = tdrv.bilinear_model(sc_t.model, sc_t.config)
    on_target = lambda x, u: torch.tensor(pf).expand(n, -1)
    args = (sc_t.config, ctx, bmodel, sc_t.model, plants, on_target, sc_t.exit_condition)
    new_t, _, _ = tdrv.advance(carry_t, tdrv.SQPState(*map(torch.tensor, s)), 4, *args)
    for a_t, a_j in zip(new_t, new_j[:5] + new_j[6:]):
        close(a_t, a_j)
    np.testing.assert_array_equal(new_t.exit_code.numpy(), [1, 0, 2, 1, 3, 2])
    np.testing.assert_array_equal(new_t.done.numpy(), [True, False, True, True, True, True])
    close(new_t.x_cur[[3, 5]], x_cur[[3, 5]])

    # one step later lane 0 stays frozen with its code; lane 1, now on the
    # target, exits
    s2 = tdrv.SQPState(*map(torch.tensor, s))._replace(code=torch.zeros(n, dtype=torch.int32))
    ctx2 = tdrv.context(new_t, 5, sc_t.config, sc_t.X_targ, sc_t.U_targ, plants)
    newer, _, _ = tdrv.advance(new_t, s2, 5, sc_t.config, ctx2, *args[2:])
    np.testing.assert_array_equal(newer.exit_code.numpy(), [1, 1, 2, 1, 3, 2])
    for f in ("x_cur", "x_true", "X_guess", "U_guess", "u_last"):
        close(getattr(newer, f)[0], getattr(new_t, f)[0])


# ------------------------------------------------------------- whole fleets

@pytest.fixture(scope="module", params=sorted(FLEETS))
def reference(request):
    """One JAX run per preset (about 15-20 s of compile and run each)."""
    kw = FLEETS[request.param][0]
    sc = getattr(jpresets, request.param)(**kw)
    plants, keys = jax_batch(jax.random.PRNGKey(1), sc.plant, B, detune_scale=0.01)
    metrics, out = jax_fleet(sc, B, cpu=True, kinv="gj", _plants=plants, _keys=keys)
    return sc, plants, metrics, out


def test_fleet_float64_matches_jax(reference):
    sc_j, plants_j, m_j, out_j = reference
    _, budget, x_tol, _ = FLEETS[sc_j.name]
    sc, plants = port_scenario(sc_j, plants_j, torch.float64)
    assert expm_budget_for(plants, sc.config.dt, sc.sat) == budget
    boxqp_small.launches = expm_small.launches = admm_big.launches = 0
    m, out = run_hostloop_fleet(sc, B, plants=plants)
    np.testing.assert_allclose(out["final_x"].numpy(), out_j["final_x"], rtol=0, atol=x_tol)
    np.testing.assert_array_equal(out["exit_code"].numpy(), out_j["exit_code"])
    for key in ("fidelity_mean", "fidelity_min", "completed_frac", "exit_early_frac",
                "qp_fail_frac", "steady_budget", "warm_budget", "warm_sqp_iters"):
        assert m[key] == m_j[key], key
    assert m["qp_kernel"] == "small" and m["completed_frac"] == 1.0
    assert m["exit_early_frac"] == (1.0 if sc.name == "not_gate" else 0.0)
    # on the CPU the kernels' plain versions ran: no launch was counted
    assert boxqp_small.launches == expm_small.launches == admm_big.launches == 0


def test_fleet_float32_matches_jax(reference):
    sc_j, plants_j, m_j, out_j = reference
    sc, plants = port_scenario(sc_j, plants_j, torch.float32)
    m, out = run_hostloop_fleet(sc, B, plants=plants)
    assert out["final_x"].dtype == torch.complex64
    fid = fleet_fidelity(sc, out["final_x"])
    targ = np.asarray(sc_j.target_state)
    fid_j = np.real(out_j["final_x"] @ np.conj(targ)) / np.real(targ @ np.conj(targ))
    np.testing.assert_allclose(fid, fid_j, rtol=0, atol=FLEETS[sc_j.name][3])
    np.testing.assert_array_equal(out["exit_code"].numpy(), out_j["exit_code"])
    assert m["completed_frac"] == 1.0 and m["qp_fail_frac"] == 0.0


def test_lindblad_float32_tracks_float64_before_branching():
    """Over its first 8 steps, while the controls sit on the box edge, the
    float32 lindblad loop follows the float64 one to ~1e-7 in fidelity
    (measured 2.4e-7 on 64 lanes); the branching that the full-length
    bound allows sets in at step 9."""
    fids = []
    for dtype in (torch.float64, torch.float32):
        sc = tpresets.lindblad_state(device="cpu", dtype=dtype)
        sc = dataclasses.replace(sc, config=dataclasses.replace(sc.config, n_steps=8))
        _, out = run_hostloop_fleet(sc, 8)
        fids.append(fleet_fidelity(sc, out["final_x"]))
    np.testing.assert_allclose(fids[1], fids[0], rtol=0, atol=1e-6)


def test_synthesis_plant_is_noiseless():
    """The synthesis plant has no sigma, as the reference's has none; the
    runner takes it as noiseless and does not refuse it."""
    sc = tpresets.not_gate(n_steps=2, device="cpu", dtype=torch.float64)
    assert not hasattr(sc.plant, "sigma")
    m, out = run_hostloop_fleet(sc, 2)
    assert out["final_x"].shape == (2, 16) and m["completed_frac"] == 1.0
