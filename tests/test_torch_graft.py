"""graft_entry_torch.py, the port's counterpart of __graft_entry__.py, on the
CPU: entry()'s one MPC step against the JAX package's entry() fn on the
same inputs (converted from its (re, im) float32 pairs), in float32 on both
sides within 1e-5 (measured 2.3e-9 on the state, the control equal: it sits
on the box edge); the dry run's rollout against JAX's in float64 within
1e-8; and the sharded dry run over 2 and 4 gloo ranks.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax

import __graft_entry__ as jgraft
import graft_entry_torch as tgraft
from mpc4quantum_tpu.parallel.fleet import batched_mpc as jax_batched_mpc
from mpc4quantum_tpu.parallel.fleet import make_scenario_batch as jax_batch
from mpc4quantum_tpu.solvers.boxqp import BoxQPParams as JBoxQPParams

from mpc4quantum_tpu_torch import batched_mpc
from mpc4quantum_tpu_torch.convert import plant_from_numpy

F32 = 1e-5
F64 = 1e-8


def test_entry_matches_jax_entry():
    jfn, jargs = jgraft.entry()
    x_re, x_im, u_j = map(np.asarray, jax.jit(jfn)(*jargs))
    x0r, x0i, Ar, Ai, Xr, Xi, U, _ = map(np.asarray, jargs)
    cx = lambda re, im: torch.tensor(re + 1j * im, dtype=torch.complex64)
    args = (cx(x0r, x0i), cx(Ar, Ai), cx(Xr, Xi), torch.tensor(U))
    fn, example = tgraft.entry(device="cpu", dtype=torch.float32)
    # the example arguments are the reference's
    for ours, theirs in zip(example, args):
        assert ours.dtype == theirs.dtype and torch.equal(ours, theirs)
    x, u = fn(*args)
    assert x.shape == (4,) and x.dtype == torch.complex64 and u.shape == (1,)
    np.testing.assert_allclose(x.numpy(), x_re + 1j * x_im, rtol=0, atol=F32)
    np.testing.assert_allclose(u.numpy(), u_j, rtol=0, atol=F32)
    # the step moved the state: the QP's first control reached the plant
    assert float((x - args[0]).abs().max()) > 1e-2


def test_dryrun_forms_match_jax():
    """Both forms of the dry run's rollout, in float64 on the lanes JAX's
    dry run draws (make_scenario_batch at PRNGKey(0)), against JAX's
    batched_mpc: states and controls within 1e-8, valid steps, exit codes
    and SQP iterations equal. The carried-duals form's 2x5 budget fails the
    first QP of every lane in both packages: exit code 2, no valid step."""
    rho0, model_j, base_j, Xt_j, Ut_j, Q_j, R_j, Qf_j, cfg_j, _ = jgraft._not_state_problem(
        order=1, H=4, n_steps=3)
    plants_j, keys = jax_batch(jax.random.PRNGKey(0), base_j, 2, detune_scale=0.01)
    cfg_wj = dataclasses.replace(cfg_j, qp_backend="ns", qp_warm_duals=True, qp_params=JBoxQPParams(
        max_iter=5, n_rounds=2, unroll=False, scale=True))
    sc, forms = tgraft.dryrun_problem(device="cpu", dtype=torch.float64)
    plants = plant_from_numpy({k: np.asarray(getattr(plants_j, k)) for k in ("H0", "H1s", "sigma")})
    for c_j, cfg in zip((cfg_j, cfg_wj), forms):
        rj = jax_batched_mpc(jax.numpy.asarray(rho0), model_j, plants_j, Xt_j, Ut_j, Q_j, R_j, Qf_j,
                             c_j, sc.sat, keys=keys)
        r = batched_mpc(sc.x0, sc.model, plants, sc.X_targ, sc.U_targ, sc.Q, sc.R, sc.Qf, cfg,
                        sc.sat)
        np.testing.assert_allclose(r.xs.numpy(), np.asarray(rj.xs), rtol=0, atol=F64)
        np.testing.assert_allclose(r.us.numpy(), np.asarray(rj.us), rtol=0, atol=F64)
        for key in ("n_valid", "exit_code", "sqp_iters"):
            np.testing.assert_array_equal(getattr(r, key).numpy(), np.asarray(getattr(rj, key)))
    assert r.n_valid.tolist() == [0, 0] and r.exit_code.tolist() == [2, 2]


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_gloo(n):
    """n gloo processes; each rank's shard of the sharded rollout equals
    batched_mpc on the same lanes, and the carried-duals form fails every
    lane's first QP."""
    out = tgraft.dryrun_multichip(n, device="cpu")
    assert out["world"] == n and out["lanes"] == 2 * n
    assert out["n_valid"] == 2 * n * 3 and out["gap_to_batched"] <= 1e-6
    assert out["n_valid_warm"] == 0
    assert not torch.distributed.is_initialized()


def test_dryrun_multichip_refuses_missing_cards():
    with pytest.raises(RuntimeError, match="CUDA devices"):
        tgraft.dryrun_multichip(torch.cuda.device_count() + 1, device="cuda")
    with pytest.raises(ValueError, match="device"):
        tgraft.dryrun_multichip(2, device="tpu")
