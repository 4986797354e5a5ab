"""The port's flagship slice against the JAX package, on the CPU.

The JAX reference is `run_hostloop_fleet(not_state, 4, cpu=True, kinv="gj")`
in x64: the XLA host loop whose box QPs use the Gauss-Jordan K-inverse, the
same algorithm as the port's QP kernel and its plain version. Both sides
run on the same JAX-drawn plant batch, carried across as numpy through
`convert.scenario_from_numpy`.

Tolerances: float64 final states within 1e-9 (the ops agree to ~1e-13 per
call; 20 closed-loop steps of ADMM keep that far below 1e-9), exit codes and
the rounded fidelity metrics equal. A float32 port run against the float64
reference within 1e-4 of per-lane fidelity.
"""

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
from mpc4quantum_tpu_torch.kernels.boxqp import boxqp_small
from mpc4quantum_tpu_torch.kernels.expm import expm_small

B = 4


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
                                 accept_rel=qp.accept_rel))
    a = np.asarray
    return scenario_from_numpy(
        sc.name, x0=a(sc.x0), A=a(sc.model.A), X_targ=a(sc.X_targ), U_targ=a(sc.U_targ),
        Q=a(sc.Q), R=a(sc.R), Qf=a(sc.Qf), sat=sc.sat, du=sc.du,
        target_state=a(sc.target_state), config=config,
        plant=(a(sc.plant.H0), a(sc.plant.H1s), a(sc.plant.sigma)),
        plants=(a(plants.H0), a(plants.H1s), a(plants.sigma)), dtype=dtype)


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


def test_import_loads_no_jax():
    code = ("import sys, mpc4quantum_tpu_torch, mpc4quantum_tpu_torch.convert; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', "
            "'mpc4quantum_tpu.')) or m == 'mpc4quantum_tpu']; print(bad); sys.exit(bool(bad))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_noisy_plants_are_refused():
    from mpc4quantum_tpu_torch import presets
    from mpc4quantum_tpu_torch.parallel.fleet import make_scenario_batch
    from mpc4quantum_tpu_torch.plants.quantum import QuantumPlant

    sc = presets.not_state()
    plants = make_scenario_batch(sc.plant, 2)
    noisy = QuantumPlant(plants.H0, plants.H1s, plants.sigma + 0.01)
    with pytest.raises(NotImplementedError, match="measurement noise"):
        run_hostloop_fleet(sc, 2, plants=noisy)
