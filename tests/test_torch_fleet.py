"""The port's fleet slices against the JAX package, on the CPU.

Flagship: the JAX reference is `run_hostloop_fleet(not_state, 4, cpu=True,
kinv="gj")` in x64, the XLA host loop whose box QPs use the Gauss-Jordan
K-inverse, the same algorithm as the port's QP kernel and its plain version.
Large-n presets (`drag_state` n = 32, `not_state_freq` n = 50): the
reference is `run_hostloop_fleet(preset(), 4, cpu=True)` in x64 with the
presets' own tuned budgets (drag: Gauss-Jordan inverse; freq: cold
Newton-Schulz; both Jacobi-scaled in the steady phase). Both sides run on
the same JAX-drawn plant batch, carried across as numpy through
`convert.scenario_from_numpy`.

Tolerances: float64 final states within 1e-9 on the flagship (the ops agree
to ~1e-13 per call) and 1e-8 on the large-n presets (measured 2e-11 drag,
5e-11 freq; the fixed-budget ADMM of the long horizons amplifies rounding
more). Drag's plant expm differs by design - the reference's XLA step runs
a fixed 2 squarings, the port's per-lane count is at most 2 - and the two
agree to Taylor-12 truncation, ~1e-10 per step. Exit codes and the rounded
fidelity metrics equal. A float32 port run against the float64 reference
within 1e-4 of per-lane fidelity, except freq: its closed loop branches
under float32 rounding (the JAX package's own float32 run ends up to 3.4e-4
from its x64 run on these lanes), so its full-length bound is 2e-3 and a
30-step float32 run, before the branching, is held to 1e-5.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax

from mpc4quantum_tpu import presets as jpresets
from mpc4quantum_tpu.benchfleet import run_hostloop_fleet as jax_fleet
from mpc4quantum_tpu.parallel.fleet import make_scenario_batch as jax_batch

from mpc4quantum_tpu_torch.benchfleet import (expm_budget_for, fleet_fidelity,
                                              run_hostloop_fleet)
from mpc4quantum_tpu_torch.convert import scenario_from_numpy
from mpc4quantum_tpu_torch.kernels.admm_big import admm_big
from mpc4quantum_tpu_torch.kernels.boxqp import boxqp_small
from mpc4quantum_tpu_torch.kernels.expm import expm_small

B = 4
# preset: (expm budget, float64 final-state bound, float32 fidelity bound)
LARGE_N = {"drag_state": ((12, 2), 1e-8, 1e-4), "not_state_freq": ((12, 0), 1e-8, 2e-3)}


@pytest.fixture(scope="module")
def reference():
    """One JAX run shared by the module (about 20 s of compile and run)."""
    sc = jpresets.not_state()
    plants, keys = jax_batch(jax.random.PRNGKey(1), sc.plant, B, detune_scale=0.01)
    metrics, out = jax_fleet(sc, B, cpu=True, kinv="gj", _plants=plants, _keys=keys)
    return sc, plants, metrics, out


def port_scenario(sc, plants, dtype):
    c, qp = sc.config, sc.config.qp_params
    config = dict(horizon=c.horizon, n_steps=c.n_steps, dt=c.dt, dim_u=c.dim_u, order=c.order,
                  measure_freq=c.measure_freq, warm_start=c.warm_start, step_tol=c.step_tol,
                  qp_params=dict(rho0=qp.rho0, sigma=qp.sigma, alpha=qp.alpha,
                                 eps_abs=qp.eps_abs, eps_rel=qp.eps_rel, max_iter=qp.max_iter,
                                 n_rounds=qp.n_rounds, accept_abs=qp.accept_abs,
                                 accept_rel=qp.accept_rel, ns_iters=qp.ns_iters,
                                 kinv=qp.kinv, scale=qp.scale))
    a = np.asarray
    return scenario_from_numpy(
        sc.name, x0=a(sc.x0), A=a(sc.model.A), X_targ=a(sc.X_targ), U_targ=a(sc.U_targ),
        Q=a(sc.Q), R=a(sc.R), Qf=a(sc.Qf), sat=sc.sat, du=sc.du,
        target_state=a(sc.target_state), config=config,
        plant={k: a(getattr(sc.plant, k)) for k in ("H0", "H1s", "sigma")},
        plants={k: a(getattr(plants, k)) for k in ("H0", "H1s", "sigma")}, device="cpu",
        dtype=dtype)


def test_fleet_float64_matches_jax(reference):
    sc_j, plants_j, m_j, out_j = reference
    sc, plants = port_scenario(sc_j, plants_j, torch.float64)
    boxqp_small.launches = expm_small.launches = 0
    m, out = run_hostloop_fleet(sc, B, plants=plants)
    np.testing.assert_allclose(out["final_x"].numpy(), out_j["final_x"], rtol=0, atol=1e-9)
    np.testing.assert_array_equal(out["exit_code"].numpy(), out_j["exit_code"])
    for key in ("fidelity_mean", "fidelity_min", "completed_frac", "qp_fail_frac",
                "steady_budget", "warm_budget", "warm_sqp_iters"):
        assert m[key] == m_j[key], key
    assert m["completed_frac"] == 1.0 and m["fidelity_min"] > 0.999
    # on the CPU the kernels' plain versions ran: no launch was counted
    assert boxqp_small.launches == 0 and expm_small.launches == 0


def test_fleet_float32_matches_jax(reference):
    sc_j, plants_j, m_j, out_j = reference
    sc, plants = port_scenario(sc_j, plants_j, torch.float32)
    m, out = run_hostloop_fleet(sc, B, plants=plants)
    assert out["final_x"].dtype == torch.complex64
    fid = fleet_fidelity(sc, out["final_x"])
    fid_j = np.real(out_j["final_x"] @ np.conj(np.asarray(sc_j.target_state)))
    np.testing.assert_allclose(fid, fid_j, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(out["exit_code"].numpy(), out_j["exit_code"])


def test_expm_budget_matches_jax_auto_budget(reference):
    sc_j, plants_j, _, _ = reference
    sc, plants = port_scenario(sc_j, plants_j, torch.float64)
    # the JAX auto budget on these plants is Taylor 12 with 0 squarings
    assert expm_budget_for(plants, sc.config.dt, sc.sat, "auto") == (12, 0)
    assert expm_budget_for(plants, sc.config.dt, sc.sat, "any_norm") == (18, 12)
    with pytest.raises(ValueError, match="expm_budget"):
        expm_budget_for(plants, sc.config.dt, sc.sat, "Auto")


@pytest.fixture(scope="module", params=sorted(LARGE_N))
def large_reference(request):
    """One JAX run per large-n preset (about 30 s of compile and run each)."""
    sc = getattr(jpresets, request.param)()
    plants, keys = jax_batch(jax.random.PRNGKey(1), sc.plant, B, detune_scale=0.01)
    metrics, out = jax_fleet(sc, B, cpu=True, _plants=plants, _keys=keys)
    return sc, plants, metrics, out


def test_large_n_fleet_float64_matches_jax(large_reference):
    sc_j, plants_j, m_j, out_j = large_reference
    budget, x_tol, _ = LARGE_N[sc_j.name]
    sc, plants = port_scenario(sc_j, plants_j, torch.float64)
    assert expm_budget_for(plants, sc.config.dt, sc.sat) == budget
    boxqp_small.launches = expm_small.launches = admm_big.launches = 0
    m, out = run_hostloop_fleet(sc, B, plants=plants)
    np.testing.assert_allclose(out["final_x"].numpy(), out_j["final_x"], rtol=0, atol=x_tol)
    np.testing.assert_array_equal(out["exit_code"].numpy(), out_j["exit_code"])
    for key in ("fidelity_mean", "fidelity_min", "completed_frac", "qp_fail_frac",
                "steady_budget", "warm_budget", "warm_sqp_iters", "qp_scale"):
        assert m[key] == m_j[key], key
    assert m["qp_kernel"] == "big" and m["qp_scale"] is True
    assert m["completed_frac"] == 1.0 and m["fidelity_min"] > 0.999
    assert boxqp_small.launches == 0 and expm_small.launches == 0 and admm_big.launches == 0


def test_large_n_fleet_float32_matches_jax(large_reference):
    sc_j, plants_j, m_j, out_j = large_reference
    _, _, fid_tol = LARGE_N[sc_j.name]
    sc, plants = port_scenario(sc_j, plants_j, torch.float32)
    m, out = run_hostloop_fleet(sc, B, plants=plants)
    assert out["final_x"].dtype == torch.complex64
    fid = fleet_fidelity(sc, out["final_x"])
    targ = np.asarray(sc_j.target_state)
    fid_j = np.real(out_j["final_x"] @ np.conj(targ)) / np.real(targ @ np.conj(targ))
    np.testing.assert_allclose(fid, fid_j, rtol=0, atol=fid_tol)
    np.testing.assert_array_equal(out["exit_code"].numpy(), out_j["exit_code"])
    assert m["completed_frac"] == 1.0 and m["fidelity_min"] > 0.999


def test_freq_float32_tracks_float64_before_branching():
    """Over its first 30 steps the float32 freq loop follows the float64
    one to ~1e-6 in fidelity (measured 8.8e-7 on 16 lanes); the branching
    that the full-length bound allows sets in later."""
    from mpc4quantum_tpu_torch import presets

    fids = []
    for dtype in (torch.float64, torch.float32):
        sc = presets.not_state_freq(device="cpu", dtype=dtype)
        sc = dataclasses.replace(sc, config=dataclasses.replace(sc.config, n_steps=30))
        _, out = run_hostloop_fleet(sc, 8)
        fids.append(fleet_fidelity(sc, out["final_x"]))
    np.testing.assert_allclose(fids[1], fids[0], rtol=0, atol=1e-5)


def test_import_loads_no_jax():
    code = ("import sys, mpc4quantum_tpu_torch, mpc4quantum_tpu_torch.convert; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', "
            "'mpc4quantum_tpu.')) or m == 'mpc4quantum_tpu']; print(bad); sys.exit(bool(bad))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_noisy_plants_are_refused():
    """A noisy fleet (sigma > 0) is refused without noise to observe it
    with, and runs with a noise tensor or a generator."""
    from mpc4quantum_tpu_torch import presets
    from mpc4quantum_tpu_torch.parallel.fleet import make_scenario_batch
    from mpc4quantum_tpu_torch.plants.quantum import QuantumPlant

    sc = presets.not_state(device="cpu", dtype=torch.float64)
    plants = make_scenario_batch(sc.plant, 2)
    noisy = QuantumPlant(plants.H0, plants.H1s, plants.sigma + 1e-4)
    with pytest.raises(ValueError, match="measurement noise"):
        run_hostloop_fleet(sc, 2, plants=noisy)
    noise = torch.randn(sc.config.n_steps, 2, 4, dtype=torch.complex128,
                        generator=torch.Generator().manual_seed(0))
    m, out = run_hostloop_fleet(sc, 2, plants=noisy, noise=noise)
    _, again = run_hostloop_fleet(sc, 2, plants=noisy,
                                  generator=torch.Generator().manual_seed(0))
    assert m["completed_frac"] == 1.0 and bool(torch.isfinite(out["final_x"]).all())
    assert again["final_x"].shape == (2, 4)
