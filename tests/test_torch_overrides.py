"""The fleet entry's overrides against the JAX package's `run_hostloop_fleet`
on the CPU (x64 there, float64 here), at the calls of the JAX package's own
tests, on JAX-drawn plant batches carried across with `convert`:

- `warm_sqp_iters` as an int and as a per-step tuple with
  `warm_duals=False` (tests/test_r4_features.py:27-32: 12 against (12, 2)
  on the flagship, equal lane for lane);
- `lqr_seed` (tests/test_r4_features.py:64-69: 6 steps, 12 warm
  iterations, cold duals);
- `warm_duals=False` on a tuned preset (tests/test_preset_tuning.py:98:
  drag keeps its own 2x150 in both phases);
- a per-step `warm_sqp_iters` on the open system
  (tests/test_lindblad.py:154: (8, 1));
- an explicit `steady_qp_params`, which implies carried duals;
- `qp_kernel`: "big" at n 10 against the default "small" (the two kernels'
  inverses differ: Gauss-Jordan inside `boxqp_small`, Newton-Schulz in
  `boxqp_big`), "small" above n 16 refused, "big_unroll" run as "big";
- the rescue pass re-runs its lanes under the same overrides.

The reference's `granularity` and `steady_fuse` pick TPU dispatch forms
and are passed to the JAX side only. Tolerances: FLEET_TOL = 1e-8 on final
states against JAX; 1e-12 between two port runs that must agree exactly
(the int and the tuple budgets); the two QP kernels at n 10 within 1e-5 on
the final states (a float32-level bound: the two inverses round
differently; in float64 the Newton-Schulz inverse converges within its 30
steps and the runs end 4.2e-13 apart).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax

from mpc4quantum_tpu import benchfleet as jbench
from mpc4quantum_tpu import presets as jpresets
from mpc4quantum_tpu.parallel.fleet import make_scenario_batch as jax_batch
from mpc4quantum_tpu.solvers.boxqp import BoxQPParams as JBoxQPParams

from mpc4quantum_tpu_torch import benchfleet as tbench
from mpc4quantum_tpu_torch import presets as tpresets
from mpc4quantum_tpu_torch.benchfleet import make_runner, run_hostloop_fleet
from mpc4quantum_tpu_torch.convert import plant_from_numpy
from mpc4quantum_tpu_torch.parallel.fleet import make_scenario_batch
from mpc4quantum_tpu_torch.solvers.boxqp import BoxQPParams

FLEET_TOL = 1e-8
EXACT = 1e-12
KERNEL_TOL = 1e-5
# the JAX tests' dispatch options, which only choose TPU program forms
JAX_FORM = dict(granularity="sqp", steady_fuse=1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(t, j, tol=FLEET_TOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=0, atol=tol)


def cut(sc, steps):
    return dataclasses.replace(sc, config=dataclasses.replace(sc.config, n_steps=steps))


def fast_qp(sc):
    """The scan form of the JAX ADMM loop for CPU traces."""
    return dataclasses.replace(sc, config=dataclasses.replace(
        sc.config, qp_params=sc.config.qp_params.replace(unroll=False)))


def plant_fields(p) -> dict:
    names = ("AH0", "AD", "A1s", "sigma") if hasattr(p, "AD") else ("H0", "H1s", "sigma")
    return {k: np.asarray(getattr(p, k)) for k in names}


def both(name, B, steps=None):
    """(JAX scenario, its JAX-drawn lane batch, the port's own preset and
    those lanes), cut to `steps`."""
    sc_j = fast_qp(jpresets.PRESETS[name]())
    sc = tpresets.PRESETS[name](device="cpu")
    if steps is not None:
        sc_j, sc = cut(sc_j, steps), cut(sc, steps)
    plants_j, keys = jax_batch(jax.random.PRNGKey(1), sc_j.plant, B, detune_scale=0.01)
    return sc_j, (plants_j, keys), sc, plant_from_numpy(plant_fields(plants_j))


def jax_run(sc_j, lanes, B, **kw):
    plants_j, keys = lanes
    return jbench.run_hostloop_fleet(sc_j, B, cpu=True, _plants=plants_j, _keys=keys, **kw)


def test_warm_iters_int_and_tuple_match_jax():
    """tests/test_r4_features.py:27-32: on the flagship with cold duals, 12
    warm iterations on every warm step equal (12, 2) lane for lane (step 1
    converges in <= 2), and both equal JAX's."""
    B = 8
    sc_j, lanes, sc, plants = both("not_state", B)
    m_j, out_j = jax_run(sc_j, lanes, B, warm_sqp_iters=12, warm_duals=False, **JAX_FORM)
    ma, outa = run_hostloop_fleet(sc, B, plants=plants, warm_sqp_iters=12, warm_duals=False)
    mb, outb = run_hostloop_fleet(sc, B, plants=plants, warm_sqp_iters=(12, 2),
                                  warm_duals=False)
    close(outa["final_x"], outb["final_x"], EXACT)
    assert ma["fidelity_min"] == mb["fidelity_min"]
    close(outa["final_x"], out_j["final_x"])
    for key in ("warm_sqp_iters", "warm_duals", "warm_budget", "steady_budget", "fidelity_min",
                "completed_frac", "qp_fail_frac"):
        assert ma[key] == m_j[key], key
    assert (ma["warm_sqp_iters"], mb["warm_sqp_iters"]) == (12, [12, 2])
    # cold duals: the flagship's own budget, 3x15 in both phases
    assert not ma["warm_duals"] and ma["warm_budget"] == ma["steady_budget"] == "3x15"


def test_lqr_seed_matches_jax():
    """tests/test_r4_features.py:64-69: the LQR-seeded initial guess, 6
    steps, 12 warm iterations, cold duals. There both guesses converge to
    the same controls on the box edge; with one warm iteration the seed
    shows."""
    B = 4
    sc_j, lanes, sc, plants = both("not_state", B, steps=6)
    m_j, out_j = jax_run(sc_j, lanes, B, warm_sqp_iters=12, warm_duals=False, lqr_seed=True,
                         **JAX_FORM)
    m, out = run_hostloop_fleet(sc, B, plants=plants, warm_sqp_iters=12, warm_duals=False,
                                lqr_seed=True)
    close(out["final_x"], out_j["final_x"])
    assert m["lqr_seed"] and m_j["lqr_seed"]
    assert make_runner(sc, plants, lqr_seed=True).config.lqr_seed
    assert not make_runner(sc, plants).config.lqr_seed
    one = [run_hostloop_fleet(sc, B, plants=plants, warm_sqp_iters=1, warm_duals=False,
                              lqr_seed=seed)[1]["final_x"] for seed in (False, True)]
    assert float((one[0] - one[1]).abs().max()) > 1e-6


def test_warm_duals_false_keeps_the_preset_budget():
    """tests/test_preset_tuning.py:98: warm_duals=False forces the cold form
    on a tuned preset: drag runs its own 2x150 in both phases (with its
    Gauss-Jordan inverse), not the tuned 2x50 / 1x19."""
    B = 4
    sc_j, lanes, sc, plants = both("drag_state", B, steps=6)
    m_j, out_j = jax_run(sc_j, lanes, B, warm_duals=False)
    m, out = run_hostloop_fleet(sc, B, plants=plants, warm_duals=False)
    close(out["final_x"], out_j["final_x"])
    for key in ("warm_duals", "steady_budget", "warm_budget", "warm_sqp_iters", "qp_scale"):
        assert m[key] == m_j[key], key
    assert not m["warm_duals"] and m["steady_budget"] == m["warm_budget"] == "2x150"
    assert m["kinv"] == "gj"


def test_lindblad_per_step_warm_iters_match_jax():
    """tests/test_lindblad.py:154: the open system with (8, 1) warm
    iterations and the tuned budgets, cut to 8 steps (float32 branches
    from step 9; in float64 the two packages agree along the whole run)."""
    B = 4
    sc_j, lanes, sc, plants = both("lindblad_state", B, steps=8)
    m_j, out_j = jax_run(sc_j, lanes, B, warm_sqp_iters=(8, 1), **JAX_FORM)
    m, out = run_hostloop_fleet(sc, B, plants=plants, warm_sqp_iters=(8, 1))
    close(out["final_x"], out_j["final_x"])
    for key in ("warm_sqp_iters", "warm_duals", "warm_budget", "steady_budget",
                "completed_frac", "qp_fail_frac"):
        assert m[key] == m_j[key], key
    assert m["warm_sqp_iters"] == [8, 1] and m["warm_duals"]


def test_explicit_steady_params_imply_warm_duals():
    """An explicit steady budget carries the duals into it, and the preset's
    tuned steady program, rho0 and Newton-Schulz cut are not applied."""
    B = 2
    sc_j, lanes, sc, plants = both("not_state", B, steps=6)
    steady = dict(max_iter=12, n_rounds=1, accept_abs=4e-3, accept_rel=4e-3)
    m_j, out_j = jax_run(sc_j, lanes, B, steady_qp_params=JBoxQPParams(unroll=False, **steady),
                         **JAX_FORM)
    m, out = run_hostloop_fleet(sc, B, plants=plants, steady_qp_params=BoxQPParams(**steady))
    close(out["final_x"], out_j["final_x"])
    for key in ("warm_duals", "steady_budget", "warm_budget"):
        assert m[key] == m_j[key], key
    assert m["warm_duals"] and m["steady_budget"] == "1x12"


def test_qp_kernel_big_at_n10_matches_small():
    """The flagship's n = 10 QPs on the large-n route: one admm_big launch a
    rho round from a Newton-Schulz K^-1, against boxqp_small's Gauss-Jordan
    inside the kernel."""
    B = 4
    sc = tpresets.not_state(device="cpu")
    plants = make_scenario_batch(sc.plant, B)
    m_s, out_s = run_hostloop_fleet(sc, B, plants=plants)
    m_b, out_b = run_hostloop_fleet(sc, B, plants=plants, qp_kernel="big")
    assert (m_s["qp_kernel"], m_b["qp_kernel"]) == ("small", "big")
    close(out_b["final_x"], out_s["final_x"], KERNEL_TOL)
    np.testing.assert_array_equal(out_b["exit_code"].numpy(), out_s["exit_code"].numpy())
    assert make_runner(sc, plants, qp_kernel="big_unroll").qp_kernel == "big"


def test_qp_kernel_small_above_16_is_refused():
    sc = tpresets.cnot_state(order=2, device="cpu")
    plants = make_scenario_batch(sc.plant, 2)
    with pytest.raises(ValueError, match="n <= 16"):
        run_hostloop_fleet(sc, 2, plants=plants, qp_kernel="small")
    with pytest.raises(ValueError, match="qp_kernel"):
        make_runner(sc, plants, qp_kernel="tiny")


def test_streaming_fleet_refuses_carried_duals():
    sc = tpresets.not_state(device="cpu")
    sc = dataclasses.replace(sc, config=dataclasses.replace(sc.config, streaming=True))
    plants = make_scenario_batch(sc.plant, 2)
    assert not make_runner(sc, plants).carry_duals
    for kw in (dict(warm_duals=True), dict(steady_qp_params=BoxQPParams())):
        with pytest.raises(ValueError, match="streaming"):
            make_runner(sc, plants, **kw)


def test_rescue_passes_the_overrides_on(monkeypatch):
    """The rescue re-runs its lanes under the main pass's overrides;
    warm_sqp_iters only when the alternative scenario has the same name,
    as the reference passes it."""
    seen = []
    real = tbench.make_runner

    def spy(sc, plants, expm_budget="auto", **runner_kw):
        seen.append((sc.name, runner_kw))
        return real(sc, plants, expm_budget, **runner_kw)

    monkeypatch.setattr(tbench, "make_runner", spy)
    sc = cut(tpresets.not_state(device="cpu"), 3)
    kw = dict(warm_sqp_iters=(5, 1), warm_duals=False, qp_kernel="big", lqr_seed=True,
              steady_qp_params=None)
    for alt, iters in ((cut(sc, 2), (5, 1)), (dataclasses.replace(cut(sc, 2), name="other"), None)):
        seen.clear()
        m, _ = run_hostloop_fleet(sc, 3, rescue={"threshold": 2.0, "scenario": alt}, **kw)
        assert m["rescued_lanes"] == 3 and len(seen) == 2
        (_, main), (name, rescue) = seen
        assert main == {**rescue, "warm_sqp_iters": (5, 1)} and name == alt.name
        assert rescue["warm_sqp_iters"] == iters
        assert (rescue["warm_duals"], rescue["qp_kernel"], rescue["lqr_seed"]) == (
            False, "big", True)
