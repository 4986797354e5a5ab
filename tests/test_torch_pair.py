"""The port's two-qubit slices, `crosstalk` and `cnot_state`, against the JAX
package on the CPU (x64 there, float64 in the port), on numpy inputs made
from a seed: the pair systems, the measurement adapters (partial-trace and
truncate lifts with their projections), both preset constructors, the expm
budget, the QP budgets the fleet entry resolves, both whole fleets on the
JAX-drawn plant batch carried across with `convert`, and the rescue pass.

The JAX side runs as its own CPU tests run it: `run_hostloop_fleet(...,
cpu=True)`, the XLA implementations, with the scan form of the ADMM loop
(`unroll=False`, the same iterates as the unrolled form, traced faster).

Tolerances: operators exact; adapters, presets and norm bounds 1e-12 (the
same arithmetic on values of order one). Whole fleets in float64: crosstalk
(coupling 0.05, B = 4, all 50 steps) final states within 1e-8 (measured
3.4e-13), cnot (order 2, B = 4, cut to 12 steps with the ramp kept) within
1e-8 (measured 3.0e-13); exit codes and the rounded metrics equal. The rescue
(cnot order 2 -> order 3 on 3 lanes, every lane marginal, padded to 4):
the same `rescued_lanes`, `rescue_batch` and `rescue_improved`, kept states
within 1e-8 (measured 3e-16). A float32 port run of either fleet ends within 1e-4 of the
reference's per-lane fidelity (measured 1.3e-5 on crosstalk; 1.1e-5 on cnot's
12 steps, whose closed loop branches under float32 rounding only between
steps 70 and 100: 4e-6 at 70 steps, 2.8e-3 at 100 while the state still
moves, 2.0e-4 at the end of 200, the JAX package's own float32 run 2.5e-4
from its x64 run). Full-length cnot in float32 is held on the card, against
the port's float64 path.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mpc4quantum_tpu import presets as jpresets
from mpc4quantum_tpu import systems as jsystems
from mpc4quantum_tpu import benchfleet as jbench
from mpc4quantum_tpu.parallel.fleet import make_scenario_batch as jax_batch
from mpc4quantum_tpu.plants import quantum as jq

from mpc4quantum_tpu_torch import benchfleet as tbench
from mpc4quantum_tpu_torch import presets as tpresets
from mpc4quantum_tpu_torch import systems as tsystems
from mpc4quantum_tpu_torch.benchfleet import (expm_budget_for, fleet_fidelity, make_runner,
                                              run_hostloop_fleet)
from mpc4quantum_tpu_torch.convert import plant_from_numpy, scenario_from_numpy
from mpc4quantum_tpu_torch.kernels.admm_big import admm_big
from mpc4quantum_tpu_torch.kernels.boxqp import boxqp_small
from mpc4quantum_tpu_torch.kernels.expm import expm_small
from mpc4quantum_tpu_torch.parallel.fleet import make_scenario_batch
from mpc4quantum_tpu_torch.plants import quantum as tq

B = 4
EXACT = 1e-12
FLEET_TOL = 1e-8
CNOT_STEPS = 12
RESCUE_LANES = 3
# preset: (constructor arguments, bench batch)
PAIR = {"crosstalk": (dict(coupling=0.05), 1024), "cnot_state": (dict(order=2), 128)}
QP_FIELDS = ("rho0", "sigma", "alpha", "eps_abs", "eps_rel", "max_iter", "n_rounds",
             "accept_abs", "accept_rel", "ns_iters", "kinv", "scale")
CONFIG_FIELDS = ("horizon", "n_steps", "dt", "dim_u", "order", "measure_freq", "warm_start",
                 "step_tol")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These fleets are a few lanes of small matrices: one thread runs them
    as fast as eight, and a pool of threads for each of several test
    processes on one machine slows them many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(t, j, tol=EXACT):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=0, atol=tol)


def crandn(rng, *shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def density(rng, *lead, d):
    """Random density matrices (..., d, d): Hermitian, PSD, unit trace."""
    G = crandn(rng, *lead, d, d)
    rho = G @ np.conj(np.swapaxes(G, -1, -2))
    return rho / np.trace(rho, axis1=-2, axis2=-1)[..., None, None]


def plant_fields(p) -> dict:
    """A JAX QuantumPlant (or lane batch) as numbers and a string."""
    return {"H0": np.asarray(p.H0), "H1s": np.asarray(p.H1s), "sigma": np.asarray(p.sigma),
            "lift_kind": p.lift_kind.value, "lift_dim": p.lift_dim}


def fast_qp(sc):
    """The scan form of the JAX ADMM loop for CPU traces."""
    return dataclasses.replace(sc, config=dataclasses.replace(
        sc.config, qp_params=sc.config.qp_params.replace(unroll=False)))


def cut(sc, steps):
    """The scenario stopped after `steps` steps, its targets kept (so cnot's
    ramp stays the 200-step one)."""
    return dataclasses.replace(sc, config=dataclasses.replace(sc.config, n_steps=steps))


def port_scenario(sc, plants, dtype):
    """The JAX scenario and lane batch carried across as numpy."""
    c, qp = sc.config, sc.config.qp_params
    config = {f: getattr(c, f) for f in CONFIG_FIELDS}
    config["qp_params"] = {f: getattr(qp, f) for f in QP_FIELDS}
    a = np.asarray
    return scenario_from_numpy(
        sc.name, x0=a(sc.x0), A=a(sc.model.A), X_targ=a(sc.X_targ), U_targ=a(sc.U_targ),
        Q=a(sc.Q), R=a(sc.R), Qf=a(sc.Qf), sat=sc.sat, du=sc.du,
        target_state=a(sc.target_state), config=config, plant=plant_fields(sc.plant),
        plants=plant_fields(plants), device="cpu", dtype=dtype)


def jax_fidelity(sc_j, out_j):
    targ = np.asarray(sc_j.target_state)
    return np.real(out_j["final_x"] @ np.conj(targ)) / np.real(targ @ np.conj(targ))


# ------------------------------------------------------------------- systems

def test_pair_systems_match_jax():
    for c in (0.0, 0.05):
        t, j = tsystems.RWACrosstalk(c), jsystems.RWACrosstalk(c)
        for name in ("H_list", "H_list_1", "H_list_2"):
            for a, b in zip(getattr(t, name), getattr(j, name), strict=True):
                np.testing.assert_array_equal(a, b)
        assert (t.dim_s, t.dim_u) == (j.dim_s, j.dim_u) == (4, 2)
    t, j = tsystems.RWACoupled(), jsystems.RWACoupled()
    for a, b in zip(t.H_list, j.H_list, strict=True):
        np.testing.assert_array_equal(a, b)
    assert (t.dim_s, t.dim_u) == (j.dim_s, j.dim_u) == (4, 3)
    np.testing.assert_array_equal(tsystems.SY, jsystems.SY)
    np.testing.assert_array_equal(tsystems.I2, jsystems.I2)
    # the model drives with SX where the plant drives with 0.5 kron(SX, I)
    np.testing.assert_array_equal(np.kron(tsystems.RWACrosstalk(0.1).H_list_1[1], tsystems.I2),
                                  2 * tsystems.RWACrosstalk(0.1).H_list[1])


# ------------------------------------------------------------------ adapters

def pair_plants(lift_kind, lift_dim=0, d=4):
    rng = np.random.default_rng(d)
    H0, H1s = crandn(rng, d, d), crandn(rng, 2, d, d)
    jp = jq.QuantumPlant.create(H0, H1s, lift_kind=jq.LiftKind(lift_kind), lift_dim=lift_dim)
    tp = tq.QuantumPlant(torch.tensor(H0), torch.tensor(H1s), torch.zeros((), dtype=torch.float64),
                         lift_kind=lift_kind, lift_dim=lift_dim)
    return tp, jp


@pytest.mark.parametrize("d", [2, 3])
def test_partial_trace_lift_and_tensor_proj_match_jax(d):
    """Dim d^4 <-> 2 d^2 (the preset's d = 2, and d = 3), on entangled
    states, batched over 5 lanes."""
    rng = np.random.default_rng(10 + d)
    tp, jp = pair_plants("partial_trace", d=d * d)
    x = density(rng, 5, d=d * d).reshape(5, -1)
    z = crandn(rng, 5, 2 * d * d)
    lifted = tp.lift(torch.tensor(x))
    assert lifted.shape == (5, 2 * d * d)
    close(lifted, jax.vmap(lambda v: jq.lift_state(jp, v))(jnp.asarray(x)))
    close(tq.partial_trace_lift(torch.tensor(x)), lifted)
    proj = tp.proj(torch.tensor(z))
    assert proj.shape == (5, d ** 4)
    close(proj, jax.vmap(lambda v: jq.proj_state(jp, v))(jnp.asarray(z)))
    # each half of the lift of a unit-trace state has unit trace
    halves = lifted.reshape(5, 2, d, d)
    close(torch.diagonal(halves, dim1=-2, dim2=-1).sum(-1), np.ones((5, 2)))
    # lift(proj(z)) == z on unit-trace halves
    zz = density(rng, 5, 2, d=d).reshape(5, -1)
    close(tp.lift(tp.proj(torch.tensor(zz))), zz)
    # an unbatched state goes through as well
    close(tq.tensor_proj(torch.tensor(z[0])), proj[0])
    close(tq.partial_trace_lift(torch.tensor(x[0])), lifted[0])


@pytest.mark.parametrize("dims", [(3, 2), (4, 2), (4, 3)])
def test_truncate_lift_and_proj_match_jax(dims):
    d, k = dims
    rng = np.random.default_rng(20 + 10 * d + k)
    tp, jp = pair_plants("truncate", lift_dim=k, d=d)
    x = density(rng, 5, d=d).reshape(5, -1)
    z = crandn(rng, 5, k * k)
    lifted = tp.lift(torch.tensor(x))
    assert lifted.shape == (5, k * k)
    close(lifted, jax.vmap(lambda v: jq.lift_state(jp, v))(jnp.asarray(x)))
    proj = tp.proj(torch.tensor(z))
    assert proj.shape == (5, d * d)
    close(proj, jax.vmap(lambda v: jq.proj_state(jp, v))(jnp.asarray(z)))
    # the padding is zero and lift(proj(z)) == z on unit-trace states
    padded = proj.reshape(5, d, d)
    assert not padded[:, k:, :].any() and not padded[:, :, k:].any()
    zz = density(rng, 5, d=k).reshape(5, -1)
    close(tp.lift(tp.proj(torch.tensor(zz))), zz)


def test_identity_adapter_and_unknown_kind():
    tp, jp = pair_plants("identity")
    x = torch.tensor(crandn(np.random.default_rng(0), 3, 16))
    assert tp.lift(x) is x and tp.proj(x) is x
    with pytest.raises(ValueError, match="lift_kind"):
        tq.QuantumPlant(tp.H0, tp.H1s, tp.sigma, lift_kind="partial-trace")


def test_plant_settings_survive_moving_slicing_and_batching():
    """`.to`, lane slicing, `make_scenario_batch` and `convert` keep the
    adapter; the tensor fields move and slice as before."""
    base = tpresets.crosstalk(coupling=0.05, device="cpu").plant
    assert base.lift_kind == "partial_trace" and set(base.tensor_fields()) == {"H0", "H1s", "sigma"}
    lanes = make_scenario_batch(base, 6, generator=torch.Generator().manual_seed(3))
    assert lanes.lift_kind == "partial_trace" and lanes.lanes == 6
    assert lanes.H0.shape == (6, 4, 4) and lanes.sigma.shape == (6,)
    eps = lanes.H0[:, 0, 0] / base.H0[0, 0] - 1
    close(lanes.H0, base.H0 * (1 + eps)[:, None, None])
    close(lanes.H1s, base.H1s.expand(6, -1, -1, -1))
    low = lanes.to("cpu", torch.float32)
    assert low.lift_kind == "partial_trace" and low.dtype == torch.complex64
    assert low.sigma.dtype == torch.float32
    part = lanes[torch.tensor([4, 1, 1])]
    assert part.lift_kind == "partial_trace" and part.lanes == 3
    close(part.H0, lanes.H0[[4, 1, 1]])
    assert lanes[:2].lift_kind == "partial_trace" and lanes[:2].lanes == 2
    # across convert, from numbers and a string
    jp = jpresets.crosstalk(coupling=0.05).plant
    back = plant_from_numpy(plant_fields(jp))
    assert isinstance(back, tq.QuantumPlant) and back.lift_kind == "partial_trace"
    close(back.H0, base.H0)
    trunc = jq.QuantumPlant.create(np.eye(3), [np.eye(3)], lift_kind=jq.LiftKind.TRUNCATE,
                                   lift_dim=2)
    back = plant_from_numpy(plant_fields(trunc))
    assert (back.lift_kind, back.lift_dim) == ("truncate", 2)
    # the settings may be left out: the identity adapter
    plain = plant_from_numpy({k: v for k, v in plant_fields(jp).items() if k[0] != "l"})
    assert isinstance(plain, tq.QuantumPlant) and plain.lift_kind == "identity"


# ------------------------------------------------------------------- presets

@pytest.mark.parametrize("name,kw", [("crosstalk", dict(coupling=0.0)),
                                     ("crosstalk", dict(coupling=0.05)),
                                     ("crosstalk", dict(coupling=0.05, order=2)),
                                     ("cnot_state", dict(order=1)),
                                     ("cnot_state", dict(order=2)),
                                     ("cnot_state", dict(order=3))])
def test_preset_matches_jax(name, kw):
    sc_j = getattr(jpresets, name)(**kw)
    sc_t = tpresets.PRESETS[name](device="cpu", dtype=torch.float64, **kw)
    for f in ("x0", "X_targ", "U_targ", "Q", "R", "Qf", "target_state"):
        close(getattr(sc_t, f), getattr(sc_j, f))
    close(sc_t.model.A, sc_j.model.A)
    for k, v in plant_fields(sc_j.plant).items():
        if k.startswith("lift"):
            assert getattr(sc_t.plant, k) == v
        else:
            close(getattr(sc_t.plant, k), v)
    assert (sc_t.sat, sc_t.du) == (sc_j.sat, sc_j.du)
    for f in CONFIG_FIELDS:
        assert getattr(sc_t.config, f) == getattr(sc_j.config, f), f
    for f in QP_FIELDS:
        assert getattr(sc_t.config.qp_params, f) == getattr(sc_j.config.qp_params, f), f
    assert sc_t.exit_condition is None and sc_j.exit_condition is None
    # model space and experiment space
    dim_x = 8 if name == "crosstalk" else 16
    assert sc_t.model.dim_x == dim_x and sc_t.x0.shape == (16,)
    assert sc_t.X_targ.shape[0] == dim_x and sc_t.target_state.shape == (16,)


def test_cnot_order_3_library_and_ramp():
    sc = tpresets.cnot_state(order=3, device="cpu")
    assert sc.model.A.shape == (16, 320)   # 20 monomials of three controls up to degree 3
    ramp = (sc.X_targ[5].real / sc.target_state[5].real).numpy()
    assert sc.X_targ.shape == (16, 251)
    close(ramp[:101], np.arange(101) / 100.0)
    close(ramp[100:], 1.0)


def test_presets_are_the_seven_of_the_jax_package():
    assert list(tpresets.PRESETS) == list(jpresets.PRESETS)
    assert len(tpresets.PRESETS) == 7


# ------------------------------------------------------------------- budgets

@pytest.mark.parametrize("name", sorted(PAIR))
def test_norm_bound_and_expm_budget_at_the_bench_batch(name):
    """Both fleets run the certified form: Taylor 12, no norm, no squaring."""
    kw, batch = PAIR[name]
    if name == "crosstalk":
        kw = dict(coupling=0.0)   # the bench's form; 0.05 below
    sc = getattr(jpresets, name)(**kw)
    jb, _ = jax_batch(jax.random.PRNGKey(1), sc.plant, batch)
    tb = plant_from_numpy(plant_fields(jb))
    bound = tb.norm_bound(sc.config.dt, sc.sat)
    assert bound == pytest.approx(jq.taylor_norm_bound(jb, sc.config.dt, sc.sat), rel=1e-14)
    assert bound * 1.3 <= 0.8
    assert bound == pytest.approx(0.314159 if name == "crosstalk" else 0.49, rel=2e-2)
    assert expm_budget_for(tb, sc.config.dt, sc.sat) == (12, 0)
    if name == "crosstalk":
        sc5 = tpresets.crosstalk(coupling=0.05, device="cpu")
        lanes = make_scenario_batch(sc5.plant, batch)
        assert expm_budget_for(lanes, sc5.config.dt, sc5.sat) == (12, 0)


def test_crosstalk_has_no_steady_program():
    """No entry in the steady table, on either side: the preset's own QP
    budget everywhere, no loosened acceptance, 4 SQP iterations on every
    step after the first."""
    assert "crosstalk" not in jbench.PRESET_STEADY_BUDGET
    assert "crosstalk" not in tbench.PRESET_STEADY_BUDGET
    assert "crosstalk" not in tbench.PRESET_WARM_BUDGET
    sc = tpresets.crosstalk(device="cpu")
    runner = make_runner(sc, make_scenario_batch(sc.plant, 2))
    own = sc.config.qp_params
    assert runner.steady_qp_params == own and runner.config.qp_params == own
    assert (own.n_rounds, own.max_iter, own.rho0, own.ns_iters) == (1, 150, 1.0, 20)
    assert (own.accept_abs, own.accept_rel, own.scale, own.kinv) == (1e-3, 1e-3, False, "ns")
    assert runner.warm_sqp_iters == tuple(jbench.PRESET_WARM_ITERS["crosstalk"]) == (7, 4)
    assert runner.qp_kernel == "big" and not sc.config.warm_start
    assert (runner.expm_taylor_k, runner.expm_max_squarings) == (12, 0)


@pytest.mark.parametrize("order", [2, 3])
def test_cnot_budgets_follow_the_jax_tables(order):
    sc = tpresets.cnot_state(order=order, device="cpu")
    runner = make_runner(sc, make_scenario_batch(sc.plant, 2))
    tuned = jbench.PRESET_STEADY_BUDGET["cnot_state"]
    warm, steady = runner.config.qp_params, runner.steady_qp_params
    assert (warm.n_rounds, warm.max_iter) == jbench.PRESET_WARM_BUDGET["cnot_state"][1] == (3, 100)
    assert (steady.n_rounds, steady.max_iter) == tuned["budget"] == (1, 80)
    assert warm.rho0 == steady.rho0 == tuned["rho0"] == 1.0
    assert warm.ns_iters == steady.ns_iters == tuned["ns_iters"] == 20
    assert warm.eps_abs == warm.eps_rel == steady.eps_abs == steady.eps_rel == 1e-8
    assert (warm.accept_abs, warm.accept_rel) == (1e-3, 1e-3)
    assert (steady.accept_abs, steady.accept_rel) == (4e-3, 4e-3)
    assert not warm.scale and not steady.scale and warm.kinv == steady.kinv == "ns"
    assert runner.warm_sqp_iters == tuple(jbench.PRESET_WARM_ITERS["cnot_state"]) == (7, 1)
    assert runner.qp_kernel == "big"
    # a caller's own warm budget survives
    own = dataclasses.replace(sc.config.qp_params, max_iter=200)
    sc2 = dataclasses.replace(sc, config=dataclasses.replace(sc.config, qp_params=own))
    kept = make_runner(sc2, make_scenario_batch(sc.plant, 2)).config.qp_params
    assert (kept.n_rounds, kept.max_iter, kept.rho0) == (3, 200, 1.0)


# -------------------------------------------------------------- whole fleets

@pytest.fixture(scope="module", params=sorted(PAIR))
def reference(request):
    """One JAX run per preset (crosstalk ~10 s, cnot's 12 steps ~20 s)."""
    name = request.param
    sc = fast_qp(getattr(jpresets, name)(**PAIR[name][0]))
    if name == "cnot_state":
        sc = cut(sc, CNOT_STEPS)
    plants, keys = jax_batch(jax.random.PRNGKey(1), sc.plant, B, detune_scale=0.01)
    metrics, out = jbench.run_hostloop_fleet(sc, B, cpu=True, _plants=plants, _keys=keys)
    return sc, plants, keys, metrics, out


def test_pair_fleet_float64_matches_jax(reference):
    sc_j, plants_j, _, m_j, out_j = reference
    sc, plants = port_scenario(sc_j, plants_j, torch.float64)
    assert expm_budget_for(plants, sc.config.dt, sc.sat) == (12, 0)
    boxqp_small.launches = expm_small.launches = admm_big.launches = 0
    m, out = run_hostloop_fleet(sc, B, plants=plants)
    assert out["final_x"].shape == (B, 16)
    np.testing.assert_allclose(out["final_x"].numpy(), out_j["final_x"], rtol=0, atol=FLEET_TOL)
    np.testing.assert_array_equal(out["exit_code"].numpy(), out_j["exit_code"])
    for key in ("fidelity_mean", "fidelity_min", "completed_frac", "exit_early_frac",
                "qp_fail_frac", "steady_budget", "warm_budget", "warm_sqp_iters", "qp_scale",
                "warm_duals"):
        assert m[key] == m_j[key], key
    assert m["qp_kernel"] == "big" and m["completed_frac"] == 1.0 and m["qp_fail_frac"] == 0.0
    assert m["expm_budget"] == [12, 0] and "rescued_lanes" not in m
    if sc.name == "crosstalk":
        assert not m_j["warm_duals"] and m["steady_budget"] == m["warm_budget"] == "1x150"
        assert m["fidelity_min"] > 0.995
        # the lanes differ: the coupling makes the detuning sweep matter
        assert float(np.ptp(fleet_fidelity(sc, out["final_x"]))) > 1e-6
    else:
        assert m_j["warm_duals"] and (m["steady_budget"], m["warm_budget"]) == ("1x80", "3x100")
    # on the CPU the kernels' plain versions ran: no launch was counted
    assert boxqp_small.launches == expm_small.launches == admm_big.launches == 0


def test_pair_fleet_float32_matches_jax(reference):
    sc_j, plants_j, _, m_j, out_j = reference
    sc, plants = port_scenario(sc_j, plants_j, torch.float32)
    m, out = run_hostloop_fleet(sc, B, plants=plants)
    assert out["final_x"].dtype == torch.complex64
    np.testing.assert_allclose(fleet_fidelity(sc, out["final_x"]), jax_fidelity(sc_j, out_j),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(out["exit_code"].numpy(), out_j["exit_code"])
    assert m["completed_frac"] == 1.0 and m["qp_fail_frac"] == 0.0


def test_port_preset_runs_as_the_carried_scenario():
    """The port's own crosstalk constructor through the fleet entry gives what
    the scenario carried across from JAX gives (same numpy plant batch)."""
    sc_j = jpresets.crosstalk(coupling=0.05)
    sc_j = cut(sc_j, 6)
    plants_j, _ = jax_batch(jax.random.PRNGKey(2), sc_j.plant, 2)
    carried, plants = port_scenario(sc_j, plants_j, torch.float64)
    own = cut(tpresets.crosstalk(coupling=0.05, device="cpu"), 6)
    _, out_c = run_hostloop_fleet(carried, 2, plants=plants)
    _, out_o = run_hostloop_fleet(own, 2, plants=plants)
    close(out_o["final_x"], out_c["final_x"])


# -------------------------------------------------------------------- rescue

def test_rescue_matches_jax():
    """cnot order 2 on 3 lanes, every lane marginal (threshold 2), rescued
    under the order-3 scenario: 3 lanes padded to a batch of 4, and each
    lane keeps the better of its two results."""
    sc2 = cut(fast_qp(jpresets.cnot_state(order=2)), CNOT_STEPS)
    sc3 = cut(fast_qp(jpresets.cnot_state(order=3)), CNOT_STEPS)
    plants_j, keys = jax_batch(jax.random.PRNGKey(1), sc2.plant, RESCUE_LANES)
    m_j, out_j = jbench.run_hostloop_fleet(sc2, RESCUE_LANES, cpu=True, _plants=plants_j,
                                           _keys=keys, rescue={"threshold": 2.0, "scenario": sc3})
    t2, plants = port_scenario(sc2, plants_j, torch.float64)
    t3, _ = port_scenario(sc3, plants_j, torch.float64)
    m_main, out_main = run_hostloop_fleet(t2, RESCUE_LANES, plants=plants)
    m, out = run_hostloop_fleet(t2, RESCUE_LANES, plants=plants,
                                rescue={"threshold": 2.0, "scenario": t3})
    for key in ("rescued_lanes", "rescue_batch", "rescue_improved", "fidelity_mean",
                "fidelity_min", "completed_frac", "qp_fail_frac"):
        assert m[key] == m_j[key], key
    assert (m["rescued_lanes"], m["rescue_batch"]) == (RESCUE_LANES, 4)
    np.testing.assert_allclose(out["final_x"].numpy(), out_j["final_x"], rtol=0, atol=FLEET_TOL)
    np.testing.assert_array_equal(out["exit_code"].numpy(), out_j["exit_code"])
    np.testing.assert_allclose(fleet_fidelity(t2, out["final_x"]), jax_fidelity(sc2, out_j),
                               rtol=0, atol=FLEET_TOL)
    # the rescue moved the lanes it improved and only those
    moved = (out["final_x"] - out_main["final_x"]).abs().amax(dim=1) > 1e-6
    assert int(moved.sum()) == m["rescue_improved"] >= 1
    assert m["fidelity_min"] >= m_main["fidelity_min"]
    assert m["rescue_launches"] == {"boxqp_small": 0, "expm_small": 0, "admm_big": 0,
                                    "condense_small": 0, "ns_cold": 0}
    assert m["rescue_s"] > 0 and m["rollouts_per_s"] > 0


def test_rescue_keeps_better_lanes_and_skips_when_none_is_marginal():
    """Port only, on the flagship: a rescue scenario that is worse (one step
    fewer) improves nothing; a threshold no lane is under runs no rescue."""
    sc = tpresets.not_state(device="cpu")
    worse = cut(sc, 10)
    plants = make_scenario_batch(sc.plant, 5, generator=torch.Generator().manual_seed(4))
    m0, out0 = run_hostloop_fleet(sc, 5, plants=plants)
    m, out = run_hostloop_fleet(sc, 5, plants=plants, rescue={"threshold": 2.0,
                                                             "scenario": worse})
    assert (m["rescued_lanes"], m["rescue_batch"], m["rescue_improved"]) == (5, 8, 0)
    close(out["final_x"], out0["final_x"])
    assert m["fidelity_min"] == m0["fidelity_min"]
    m, _ = run_hostloop_fleet(sc, 5, plants=plants, rescue={"threshold": 0.5, "scenario": worse})
    assert "rescued_lanes" not in m and "rescue_launches" not in m
    # a rescue from a worse main pass takes the better result for every lane
    m, out = run_hostloop_fleet(worse, 5, plants=plants, rescue={"threshold": 2.0,
                                                                "scenario": sc})
    assert m["rescue_improved"] == 5
    close(out["final_x"], out0["final_x"])


@pytest.mark.parametrize("budget", ["auto", "any_norm"])
def test_rescue_passes_the_expm_budget_on(monkeypatch, budget):
    """The reference's rescue recursion drops `expm_budget`; the port's
    rescue runs under the budget the caller chose."""
    seen = []
    real = tbench.make_runner

    def spy(sc, plants, expm_budget="auto", **runner_kw):
        runner = real(sc, plants, expm_budget, **runner_kw)
        seen.append((sc.config.n_steps, plants.lanes, expm_budget,
                     (runner.expm_taylor_k, runner.expm_max_squarings)))
        return runner

    monkeypatch.setattr(tbench, "make_runner", spy)
    sc = cut(tpresets.not_state(device="cpu"), 3)
    alt = cut(sc, 2)
    run_hostloop_fleet(sc, 3, expm_budget=budget, rescue={"threshold": 2.0, "scenario": alt})
    form = (12, 0) if budget == "auto" else (18, 12)
    assert seen == [(3, 3, budget, form), (2, 4, budget, form)]
    with pytest.raises(ValueError, match="expm_budget"):
        run_hostloop_fleet(sc, 3, expm_budget="Auto", rescue={"threshold": 2.0, "scenario": alt})
