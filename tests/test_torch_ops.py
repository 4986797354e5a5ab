"""Module-level parity of the PyTorch port with the JAX package.

The same seeded numpy inputs go through each JAX function (on the CPU in
x64, set by conftest.py) and its port, in float64. Tolerance 1e-10
(absolute, on values of order one): the algorithms are the same and only
the order of floating-point operations differs.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mpc4quantum_tpu.ops import bilinear as jbil, library as jlib, liouville as jliou
from mpc4quantum_tpu.ops.expm import expm_taylor as j_expm_taylor
from mpc4quantum_tpu.mpc import driver as jdrv
from mpc4quantum_tpu.models.dmdc import dmdc_from_operator as j_dmdc, predict as j_predict
from mpc4quantum_tpu.plants import quantum as jq
from mpc4quantum_tpu.solvers import condense as jcond
from mpc4quantum_tpu.utils.linalg import gj_inverse as j_gj_inverse
from mpc4quantum_tpu import presets as jpresets, systems as jsystems

from mpc4quantum_tpu_torch.ops import bilinear as tbil, library as tlib, liouville as tliou
from mpc4quantum_tpu_torch.ops.expm import expm_taylor as t_expm_taylor
from mpc4quantum_tpu_torch.mpc import driver as tdrv
from mpc4quantum_tpu_torch.models.dmdc import dmdc_from_operator as t_dmdc, predict as t_predict
from mpc4quantum_tpu_torch.plants import quantum as tq
from mpc4quantum_tpu_torch.parallel.fleet import make_scenario_batch
from mpc4quantum_tpu_torch.solvers import condense as tcond
from mpc4quantum_tpu_torch.utils.linalg import gj_inverse as t_gj_inverse
from mpc4quantum_tpu_torch import presets as tpresets, systems as tsystems

TOL = 1e-10


def close(t, j, tol=TOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=0, atol=tol)


def crandn(rng, *shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


@pytest.mark.parametrize("order,dim_u", [(1, 1), (2, 1), (2, 2), (3, 2)])
def test_library_matches_jax(order, dim_u):
    rng = np.random.default_rng(order * 10 + dim_u)
    np.testing.assert_array_equal(tlib.control_powers(order, dim_u),
                                  jlib.control_powers(order, dim_u))
    us = rng.normal(size=(dim_u, 5))
    powers = jlib.control_powers(order, dim_u)
    close(tlib.lift_controls(torch.tensor(us), powers), jlib.lift_controls(jnp.asarray(us), powers))
    dp, dc = jlib.diff_library_powers(order, dim_u)
    tdp, tdc = tlib.diff_library_powers(order, dim_u)
    np.testing.assert_array_equal(tdp, dp)
    np.testing.assert_array_equal(tdc, dc)
    close(tlib.diff_lift_controls(torch.tensor(us), dp, dc),
          jlib.diff_lift_controls(jnp.asarray(us), dp, dc))
    A, B = crandn(rng, 3, 5), rng.normal(size=(4, 5))
    close(tlib.krtimes(torch.tensor(A), torch.tensor(B)), jlib.krtimes(jnp.asarray(A), jnp.asarray(B)))


@pytest.mark.parametrize("d", [2, 3])
def test_liouville_matches_jax(d):
    rng = np.random.default_rng(d)
    Hs = []
    for _ in range(3):
        G = crandn(rng, d, d)
        Hs.append(0.5 * (G + G.conj().T))
    basis = jsystems.matrix_units(d)
    A_j = [np.asarray(jliou.vectorize_me(H, basis)) for H in Hs]
    A_t = [tliou.vectorize_me(H, tsystems.matrix_units(d)) for H in Hs]
    for a_t, a_j in zip(A_t, A_j):
        close(a_t, a_j)
    close(tliou.discretize_homogeneous(A_t, 0.3, 2), jliou.discretize_homogeneous(A_j, 0.3, 2))


def _random_bilinear(rng, dim_x, dim_u, order):
    L = jlib.size_of_library(order, dim_u)
    A_op = crandn(rng, dim_x, dim_x) * 0.3
    N_op = crandn(rng, dim_x, dim_x * (L - 1)) * 0.3
    return A_op, N_op


@pytest.mark.parametrize("dim_u,order", [(1, 2), (2, 2), (2, 1)])
def test_model_along_traj_matches_jax(dim_u, order):
    rng = np.random.default_rng(7 + dim_u + order)
    dim_x, H, B = 4, 6, 3
    A_op, N_op = _random_bilinear(rng, dim_x, dim_u, order)
    X, U = crandn(rng, B, dim_x, H), rng.normal(size=(B, dim_u, H))
    bm_t = tbil.BilinearModel.from_stacked(torch.tensor(A_op), torch.tensor(N_op), dim_u, order)
    bm_j = jbil.BilinearModel.from_stacked(jnp.asarray(A_op), jnp.asarray(N_op), dim_u, order)
    out_t = tbil.model_along_traj(bm_t, torch.tensor(X), torch.tensor(U))
    out_j = jax.vmap(lambda x, u: jbil.model_along_traj(bm_j, x, u))(jnp.asarray(X), jnp.asarray(U))
    for a_t, a_j in zip(out_t, out_j):
        close(a_t, a_j)
    with pytest.raises(ValueError, match="Dimension mismatch"):
        tbil.BilinearModel.from_stacked(torch.tensor(A_op), torch.tensor(N_op), dim_u + 1, order)


def test_gj_inverse_matches_jax():
    rng = np.random.default_rng(3)
    G = rng.normal(size=(5, 10, 10))
    K = np.einsum("bij,bkj->bik", G, G) + 0.5 * np.eye(10)
    close(t_gj_inverse(torch.tensor(K)), j_gj_inverse(jnp.asarray(K)), tol=1e-9)


def _qp_inputs(rng, B=3, dim_x=4, dim_u=2, H=5):
    return dict(
        A_s=crandn(rng, B, H, dim_x, dim_x) * 0.4, B_s=crandn(rng, B, H, dim_x, dim_u) * 0.4,
        D_s=crandn(rng, B, H, dim_x) * 0.1, x_init=crandn(rng, B, dim_x),
        X_bm=crandn(rng, dim_x, H + 1), U_bm=rng.normal(size=(dim_u, H)),
        Q_s=np.stack([np.diag(rng.uniform(0.5, 1.5, dim_x)).astype(complex)] * (H + 1)),
        R_s=np.stack([np.diag(rng.uniform(0.1, 0.2, dim_u))] * H),
        u_prev=rng.normal(size=(B, dim_u)) * 0.3)


def test_condense_matches_jax():
    rng = np.random.default_rng(11)
    d = _qp_inputs(rng)
    t = {k: torch.tensor(v) for k, v in d.items()}
    j = {k: jnp.asarray(v) for k, v in d.items()}
    sat, du = 0.6, 0.25
    out_t = tcond.qp_data(t["x_init"], t["X_bm"], t["U_bm"], t["Q_s"], t["R_s"], t["A_s"],
                          t["B_s"], t["D_s"], t["u_prev"], sat, du)
    out_j = jax.vmap(lambda x, A, B, D, up: jcond.qp_data(
        x, j["X_bm"], j["U_bm"], j["Q_s"], j["R_s"], A, B, D, u_prev=up, sat=sat, du=du,
        unroll=True))(j["x_init"], j["A_s"], j["B_s"], j["D_s"], j["u_prev"])
    for a_t, a_j in zip(out_t, out_j):
        close(a_t, a_j)
    Uvec = rng.normal(size=(3, 10)) * 0.3
    fin_t = tcond.qp_finish(out_t[4], out_t[5], torch.tensor(Uvec), t["X_bm"], t["U_bm"],
                            t["Q_s"], t["R_s"])
    fin_j = jax.vmap(lambda w, M, u: jcond.qp_finish(w, M, u, j["X_bm"], j["U_bm"], j["Q_s"],
                                                     j["R_s"]))(out_j[4], out_j[5], jnp.asarray(Uvec))
    for a_t, a_j in zip(fin_t, fin_j):
        close(a_t, a_j)


def _sqp_state(rng, B, dim_x, dim_u, H):
    X = crandn(rng, B, dim_x, H + 1)
    U = rng.normal(size=(B, dim_u, H))
    return (X, U, X, U, np.full(B, np.inf), np.zeros(B, np.int32), np.zeros(B, bool),
            np.zeros(B, np.int32), rng.normal(size=(B, H * dim_u)), rng.uniform(0.1, 1, B))


@pytest.mark.parametrize("single_shot", [False, True])
def test_line_search_and_sqp_update_match_jax(single_shot):
    rng = np.random.default_rng(5)
    B, dim_x, dim_u, H = 4, 4, 2, 5
    d = _qp_inputs(rng, B, dim_x, dim_u, H)
    s = _sqp_state(rng, B, dim_x, dim_u, H)
    X_opt = s[0] + 0.1 * crandn(rng, B, dim_x, H + 1)
    U_opt = s[1] + 0.1 * rng.normal(size=(B, dim_u, H))
    obj = rng.uniform(0, 1, B)
    obj[2] = np.inf  # non-finite objective -> code 3
    conv = np.array([True, False, True, True])  # lane 1 fails -> code 2
    y, rho = rng.normal(size=(B, H * dim_u)), rng.uniform(0.1, 1, B)
    X_bm, U_bm = d["X_bm"], d["U_bm"]

    alpha_t, small_t = tdrv._line_search_alpha(*map(torch.tensor, (
        d["Q_s"], d["R_s"], X_bm, U_bm, s[0], s[1], X_opt, U_opt)), 1e-4)
    alpha_j, small_j = jax.vmap(lambda Xg, Ug, Xo, Uo: jdrv._line_search_alpha(
        jnp.asarray(d["Q_s"]), jnp.asarray(d["R_s"]), jnp.asarray(X_bm), jnp.asarray(U_bm),
        Xg, Ug, Xo, Uo, 1e-4))(*map(jnp.asarray, (s[0], s[1], X_opt, U_opt)))
    close(alpha_t, alpha_j)
    np.testing.assert_array_equal(small_t.numpy(), np.asarray(small_j))
    assert bool(((alpha_t > 0) & (alpha_t < 1)).any())  # a non-trivial line search

    res_t = tcond.QPResult(X=torch.tensor(X_opt), U=torch.tensor(U_opt), obj=torch.tensor(obj),
                           converged=torch.tensor(conv), y=torch.tensor(y), rho=torch.tensor(rho))
    st = tdrv.SQPState(*map(torch.tensor, s))
    out_t = tdrv.sqp_update_from_qp(st, res_t, torch.tensor(X_bm), torch.tensor(U_bm),
                                    torch.tensor(d["Q_s"]), torch.tensor(d["R_s"]), single_shot, 1e-4)

    def one(si, Xo, Uo, ob, cv, yi, ri):
        res = jcond.QPResult(X=Xo, U=Uo, obj=ob, iters=jnp.asarray(0), converged=cv, y=yi, rho=ri)
        return jdrv.sqp_update_from_qp(si, res, jnp.asarray(X_bm), jnp.asarray(U_bm),
                                       jnp.asarray(d["Q_s"]), jnp.asarray(d["R_s"]),
                                       jnp.asarray(single_shot), 1e-4)
    out_j = jax.vmap(one)(tuple(map(jnp.asarray, s)), *map(jnp.asarray, (X_opt, U_opt, obj, conv, y, rho)))
    for a_t, a_j in zip(out_t, out_j):
        close(a_t, a_j)
    np.testing.assert_array_equal(out_t.code.numpy(), [0, 2, 3, 0])


def test_expm_taylor_and_quantum_step_match_jax():
    rng = np.random.default_rng(13)
    A = crandn(rng, 6, 3, 3) * np.array([0.05, 0.5, 1, 3, 20, 200])[:, None, None]
    # entries reach 1e234 at the largest norms: relative tolerance there
    np.testing.assert_allclose(t_expm_taylor(torch.tensor(A), order=18, max_squarings=12),
                               j_expm_taylor(jnp.asarray(A), order=18, max_squarings=12),
                               rtol=TOL, atol=TOL)
    small = A[:3] / 4
    close(t_expm_taylor(torch.tensor(small), order=12, fixed_squarings=0),
          j_expm_taylor(jnp.asarray(small), order=12, fixed_squarings=0))
    # one ZOH plant step per lane, and the host-side norm bound
    B, d = 3, 2
    G = crandn(rng, B, d, d)
    H0 = 0.5 * (G + np.conj(np.swapaxes(G, 1, 2))) * 0.1
    H1s = np.stack([[0.5 * jsystems.SX]] * B) * (1 + 0.01 * rng.normal(size=(B, 1, 1, 1)))
    rho = crandn(rng, B, d * d)
    u = rng.normal(size=(B, 1)) * 0.3
    tp = tq.QuantumPlant(torch.tensor(H0), torch.tensor(H1s), torch.zeros(B, dtype=torch.float64))
    jp = jq.QuantumPlant.create(H0[0], H1s[0])
    out_j = jax.vmap(lambda h0, h1, r, uu: jq.quantum_step_taylor(
        jp.replace(H0=h0, H1s=h1), r, uu, 1.0, fixed_squarings=1, order=12))(
        jnp.asarray(H0), jnp.asarray(H1s), jnp.asarray(rho), jnp.asarray(u))
    close(tq.quantum_step_taylor(tp, torch.tensor(rho), torch.tensor(u), 1.0,
                                 fixed_squarings=1, order=12), out_j)
    jbatch = jp.replace(H0=jnp.asarray(H0), H1s=jnp.asarray(H1s))
    assert tq.taylor_norm_bound(tp, 1.0, 0.6) == pytest.approx(
        jq.taylor_norm_bound(jbatch, 1.0, 0.6), rel=1e-14)


def test_dmdc_predict_matches_jax():
    rng = np.random.default_rng(17)
    A = crandn(rng, 4, 12)
    x, u = crandn(rng, 4, 5), crandn(rng, 8, 5)
    close(t_predict(t_dmdc(torch.tensor(A), 4, 4, 8), torch.tensor(x), torch.tensor(u)),
          j_predict(j_dmdc(jnp.asarray(A), 4, 4, 8), jnp.asarray(x), jnp.asarray(u)))


def test_not_state_preset_matches_jax():
    sc_j = jpresets.not_state()
    sc_t = tpresets.not_state(device="cpu", dtype=torch.float64)
    for name in ("x0", "X_targ", "U_targ", "Q", "R", "Qf", "target_state"):
        close(getattr(sc_t, name), getattr(sc_j, name))
    close(sc_t.model.A, sc_j.model.A)
    close(sc_t.plant.H0, sc_j.plant.H0)
    close(sc_t.plant.H1s, sc_j.plant.H1s)
    assert (sc_t.sat, sc_t.du) == (sc_j.sat, sc_j.du)
    for f in ("horizon", "n_steps", "dt", "dim_u", "order", "measure_freq", "warm_start", "step_tol"):
        assert getattr(sc_t.config, f) == getattr(sc_j.config, f)


def test_scenario_batch_same_plants_on_any_dtype():
    base = tpresets.not_state(device="cpu", dtype=torch.float64).plant
    g = lambda: torch.Generator().manual_seed(3)
    p64 = make_scenario_batch(base, 32, generator=g())
    p32 = make_scenario_batch(base, 32, generator=g(), dtype=torch.float32)
    assert p64.H0.dtype == torch.complex128 and p32.H0.dtype == torch.complex64
    close(p32.H0.to(torch.complex128), p64.H0, tol=1e-7)
    # drift scaled per lane by 1 + eps, eps ~ N(0, 0.01^2); the drive untouched
    eps = (p64.H0[:, 0, 0] / base.H0[0, 0]).real - 1
    assert 0.003 < float(eps.std()) < 0.02
    close(p64.H1s, base.H1s.expand(32, -1, -1, -1))


@pytest.mark.parametrize("measure_freq,step", [(1, 0), (2, 4)])
def test_advance_matches_jax(measure_freq, step):
    """The advance: plant step, observation or model closure between
    measurements, guess and dual shifts, done-lane freezes, failed-step
    holds and exit codes - against the JAX make_mpc_step(...).advance."""
    import dataclasses
    import functools
    from mpc4quantum_tpu.parallel.fleet import make_scenario_batch as jax_batch

    rng = np.random.default_rng(19 + step)
    B, dim_x, H = 5, 4, 10
    sc_j = jpresets.not_state()
    sc_t = tpresets.not_state(device="cpu", dtype=torch.float64)
    cfg_j = dataclasses.replace(sc_j.config, measure_freq=measure_freq)
    cfg_t = dataclasses.replace(sc_t.config, measure_freq=measure_freq)
    plants_j, keys = jax_batch(jax.random.PRNGKey(0), sc_j.plant, B)
    plants_t = tq.QuantumPlant(torch.tensor(np.asarray(plants_j.H0)),
                               torch.tensor(np.asarray(plants_j.H1s)),
                               torch.tensor(np.asarray(plants_j.sigma)))
    done = np.array([False, True, False, False, False])
    carry = (crandn(rng, B, dim_x), crandn(rng, B, dim_x), crandn(rng, B, dim_x, H + 1),
             rng.normal(size=(B, 1, H)), rng.normal(size=(B, 1)),
             np.array([0, 2, 0, 0, 0], np.int32), done)
    s = (crandn(rng, B, dim_x, H + 1), rng.normal(size=(B, 1, H)), crandn(rng, B, dim_x, H + 1),
         rng.normal(size=(B, 1, H)) * 0.5, rng.uniform(0, 1, B), np.full(B, 3, np.int32),
         np.ones(B, bool), np.array([0, 0, 2, 3, 0], np.int32), rng.normal(size=(B, H)),
         rng.uniform(0.1, 1, B))

    Q_s = jnp.concatenate([jnp.tile(sc_j.Q[None], (H, 1, 1)), sc_j.Qf[None]])
    R_s = jnp.tile(sc_j.R[None], (H, 1, 1))
    step_fn = jdrv.make_mpc_step(cfg_j, Q_s, R_s, sc_j.sat, sc_j.du, plant_step_fn=functools.partial(
        jq.quantum_step_taylor, fixed_squarings=0, order=12))
    carry_j = tuple(map(jnp.asarray, carry[:5])) + (keys,) + tuple(map(jnp.asarray, carry[5:]))
    new_j, _, outs_j = jax.vmap(lambda c, si, p: step_fn.advance(
        c, si, step, p, sc_j.model, sc_j.X_targ, sc_j.U_targ))(
        carry_j, tuple(map(jnp.asarray, s)), plants_j)

    carry_t = tdrv.Carry(*map(torch.tensor, carry))
    ctx = tdrv.context(carry_t, step, cfg_t, sc_t.X_targ, sc_t.U_targ, plants_t)
    new_t, duals_t, _ = tdrv.advance(
        carry_t, tdrv.SQPState(*map(torch.tensor, s)), step, cfg_t, ctx,
        tdrv.bilinear_model(sc_t.model, cfg_t), sc_t.model, plants_t,
        lambda x, u: tq.quantum_step_taylor(plants_t, x, u, cfg_t.dt, fixed_squarings=0, order=12))
    jfields = new_j[:5] + new_j[6:]
    for a_t, a_j in zip(new_t, jfields):
        close(a_t, a_j)
    for a_t, a_j in zip(duals_t, outs_j[5]):
        close(a_t, a_j)
    np.testing.assert_array_equal(new_t.exit_code.numpy(), [0, 2, 2, 3, 0])
