"""The port's real-state path against the JAX package, on the CPU in float64
(x64 on the JAX side) from numpy seeds: the classical plants and their RK4
integrator, the Van der Pol Koopman MPC (a real DMDc model fitted by
`train_model`, `mpc()` on the chol and the kernel route), the real-embedded
problem (`mpc/embedded.py`) against the complex loop and against the JAX
package's embedded run, and what a real state asks of the plant surface:
moving, slicing, batching, noise, checkpoints, no expm budget where there
is no expm, no streaming refit in embedded mode.

Tolerances: the integrator and the embeddings 1e-12 (the same arithmetic);
against scipy's solve_ivp 1e-6 (the JAX test's bar: RK4 at 16 substeps);
train_model 1e-10 on the operator; the VdP rollouts 1e-8 on controls and
states and the JAX test's |x_final| < 0.2; the embedded
loop against the port's complex loop 1e-12 (the embedding is an algebra
isomorphism), against the JAX embedded run us 1e-6 and x_final 1e-8 (JAX's
own embedded-vs-complex bars: its kernel route inverts by Newton-Schulz,
the port's n = 10 kernel by Gauss-Jordan).
"""

import dataclasses
import os

import numpy as np
import pytest
import scipy.integrate
import torch
import jax
import jax.numpy as jnp

import mpc4quantum_tpu as m4q
from mpc4quantum_tpu import presets as jpresets
from mpc4quantum_tpu.models.dmdc import dmdc_from_operator as jax_dmdc_from_operator
from mpc4quantum_tpu.models.training import train_model as jax_train_model
from mpc4quantum_tpu.mpc import embedded as je
from mpc4quantum_tpu.plants import classical as jc
from mpc4quantum_tpu.plants import quantum as jq
from mpc4quantum_tpu.solvers.boxqp import BoxQPParams as JBoxQPParams

import mpc4quantum_tpu_torch as tm
from mpc4quantum_tpu_torch import convert
from mpc4quantum_tpu_torch.benchfleet import expm_budget_for
from mpc4quantum_tpu_torch.kernels.admm_big import admm_big
from mpc4quantum_tpu_torch.kernels.boxqp import boxqp_small
from mpc4quantum_tpu_torch.kernels.expm import expm_small
from mpc4quantum_tpu_torch.models.dmdc import dmdc_from_operator, online_fit_iteration
from mpc4quantum_tpu_torch.mpc import embedded as te
from mpc4quantum_tpu_torch.mpc import fleet_runner
from mpc4quantum_tpu_torch.mpc.fleet_runner import FleetRunner
from mpc4quantum_tpu_torch.parallel.fleet import make_scenario_batch
from mpc4quantum_tpu_torch.plants import classical as tc
from mpc4quantum_tpu_torch.plants import quantum as tq
from mpc4quantum_tpu_torch.solvers.boxqp import BoxQPParams

from test_torch_learn import PAULIS, port_scenario

EXACT = 1e-12
LOOP = 1e-8
MU, DT = 1.0, 0.1
H_VDP, STEPS_VDP, SAT_VDP = 20, 60, 4.0


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


def N(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def close(t, j, tol=EXACT):
    np.testing.assert_allclose(N(t), np.asarray(j), rtol=0, atol=tol)


def lift4(x):
    x1, x2 = x[0], x[1]
    return jnp.stack([x1, x2, x1 ** 2, x1 ** 2 * x2])


# ------------------------------------------------------ plants and RK4

@pytest.mark.parametrize("interp", ["zoh", "linear"])
def test_rk4_matches_jax_and_scipy(interp):
    """One plant against JAX's rk4_simulate and scipy's solve_ivp with the
    same controls (test_classical_mpc.py), and a lane batch of Van der Pol
    plants with their own mu against JAX plant by plant."""
    rng = np.random.default_rng(0)
    us = rng.normal(size=(1, 12)) * 0.5
    x0 = np.array([0.5, -0.2])
    dt = 0.2
    ref = np.asarray(jc.rk4_simulate(jc.VanDerPol(mu=1.0, substeps=16), jnp.asarray(x0),
                                     jnp.asarray(us), dt, interp=interp))
    ours = tc.rk4_simulate(tc.VanDerPol(1.0, substeps=16, device="cpu"), T(x0), T(us), dt,
                           interp=interp)
    assert ours.shape == (2, 13) and ours.dtype == torch.float64
    close(ours, ref)

    def u_of_t(t):
        k = min(int(t / dt), 11)
        if interp == "zoh":
            return us[0, k]
        k1 = min(k + 1, 11)
        return us[0, k] + (us[0, k1] - us[0, k]) * (t - k * dt) / dt

    sol = scipy.integrate.solve_ivp(
        lambda t, x: [x[1], -x[0] + (1 - x[0] ** 2) * x[1] + u_of_t(t)], (0, 12 * dt), x0,
        t_eval=np.arange(13) * dt, rtol=1e-10, atol=1e-12, max_step=dt / 4)
    close(ours, sol.y, tol=1e-6)

    mus = np.array([0.5, 1.0, 2.0])
    lanes = convert.classical_from_numpy("VanDerPol", mus, substeps=16, device="cpu")
    X0 = rng.normal(size=(3, 2))
    U = rng.normal(size=(3, 1, 12)) * 0.5
    batch = tc.rk4_simulate(lanes, T(X0), T(U), dt, interp=interp)
    assert batch.shape == (3, 2, 13)
    for b, mu in enumerate(mus):
        close(batch[b], jc.rk4_simulate(jc.VanDerPol(mu=mu, substeps=16), jnp.asarray(X0[b]),
                                        jnp.asarray(U[b]), dt, interp=interp))
    # one step of a lane batch is one ZOH interval
    close(lanes.step(T(X0), T(U[:, :, 0]), dt), N(tc.rk4_simulate(lanes, T(X0), T(U), dt)[..., 1]))


def test_rotor_matches_jax():
    rng = np.random.default_rng(1)
    us = rng.normal(size=(1, 10))
    x0 = np.array([1.0, 0.0])
    ref = jc.rk4_simulate(jc.Rotor(0.3), jnp.asarray(x0), jnp.asarray(us), 0.1)
    plant = tc.Rotor(0.3, device="cpu")
    close(tc.rk4_simulate(plant, T(x0), T(us), 0.1), ref)
    close(plant.lift(T(x0)), x0, tol=0)
    # a rotation keeps the norm, up to RK4's error
    assert abs(float(tc.rk4_simulate(plant, T(x0), T(us), 0.1)[:, -1].norm()) - 1.0) < 1e-6


def test_real_state_plants_move_slice_and_batch():
    """A classical plant and an embedded quantum plant through the plant
    surface: real states, moving, lane slicing, detuned batches, and no expm
    budget for a plant without an expm."""
    vdp = tc.VanDerPol(MU, device="cpu")
    assert vdp.real_state and vdp.dtype == vdp.real_dtype == torch.float64
    lanes = make_scenario_batch(vdp, 5, generator=torch.Generator().manual_seed(3))
    assert lanes.lanes == 5 and lanes.param.shape == (5,) and lanes.rhs is vdp.rhs
    assert float(lanes.param.std()) > 0 and lanes[1:3].lanes == 2
    f32 = lanes.to("cpu", torch.float32)
    assert f32.dtype == torch.float32 and f32.lift_map is tc.vdp_lift
    with pytest.raises(ValueError, match="without an expm"):
        vdp.norm_bound(0.1, 4.0)
    with pytest.raises(ValueError, match="without an expm"):
        expm_budget_for(lanes, 0.1, 4.0)

    sc = tm.presets.not_state(device="cpu")
    emb = te.EmbeddedPlant(sc.plant)
    assert emb.real_state and emb.dtype == torch.float64 and emb.n_obs == 8
    batch = make_scenario_batch(emb, 4, generator=torch.Generator().manual_seed(3))
    ref = make_scenario_batch(sc.plant, 4, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(batch.base.H0, ref.H0, rtol=0, atol=0)
    assert batch[2:].lanes == 2 and batch.to("cpu", torch.float32).base.H0.dtype == torch.complex64
    assert expm_budget_for(batch, 1.0, sc.sat) == expm_budget_for(ref, 1.0, sc.sat)
    x = te.embed_vec(sc.x0.expand(4, -1))
    u = torch.full((4, 1), 0.3, dtype=torch.float64)
    expm_small.launches = 0
    close(batch.step(x, u, 1.0, 12, 0), N(te.embed_vec(ref.step(sc.x0.expand(4, -1), u, 1.0,
                                                                12, 0))))
    assert expm_small.launches == 0  # the plain version on the CPU


# -------------------------------------------------- Van der Pol Koopman MPC

@pytest.fixture(scope="module")
def vdp_models():
    """The training data of test_classical_mpc.py (400 random-drive steps from
    numpy seed 0) and both packages' fitted models."""
    rng = np.random.default_rng(0)
    x0 = np.array([1.0, 0.5])
    us = rng.uniform(-2, 2, size=(1, 400))
    xs = np.asarray(jc.rk4_simulate(jc.VanDerPol(mu=MU, substeps=8), jnp.asarray(x0),
                                    jnp.asarray(us), DT))
    zs = np.asarray(jax.vmap(lift4, in_axes=1, out_axes=1)(jnp.asarray(xs)))
    jmodel, jrcond, jlosses = jax_train_model(jnp.asarray(zs[:, 1:]), jnp.asarray(zs[:, :-1]),
                                              jnp.asarray(us))
    txs = tc.rk4_simulate(tc.VanDerPol(MU, device="cpu"), T(x0), T(us), DT)
    close(txs, xs)
    tzs = tc.vdp_lift(txs.T).T
    tmodel, trcond, tlosses = tm.train_model(tzs[:, 1:], tzs[:, :-1], T(us))
    return (jmodel, jrcond, jlosses), (tmodel, trcond, tlosses)


def test_train_model_on_real_data_matches_jax(vdp_models):
    (jmodel, jrcond, jlosses), (tmodel, trcond, tlosses) = vdp_models
    assert tmodel.A.dtype == torch.float64 and trcond == float(jrcond)
    close(tlosses, jlosses, tol=1e-8 * float(np.abs(jlosses).max()))
    close(tmodel.A, jmodel.A, tol=1e-10)
    # the JAX fit carried across as it is
    fields = {f.name: getattr(jmodel, f.name) for f in dataclasses.fields(jmodel)}
    carried = convert.model_from_numpy(jax.tree.map(np.asarray, fields), device="cpu")
    assert type(carried).__name__ == "DiscrepDMDc" and carried.A.dtype == torch.float64
    close(carried.A, jmodel.A, tol=0)


@pytest.mark.parametrize("backend", ["chol", "ns"])
def test_vdp_koopman_mpc_matches_jax(vdp_models, backend):
    """Drive the oscillator from (1.5, 0) to the origin, H 20, 60 steps, sat
    4, through JAX's mpc() with the classical hooks and the port's mpc() on
    the classical plant, on the chol default and on the kernel route (n = 20:
    boxqp_big and the plain admm_big on the CPU)."""
    (jmodel, _, _), _ = vdp_models
    X_targ = np.zeros((4, STEPS_VDP + H_VDP + 1))
    U_targ = np.zeros((1, STEPS_VDP + H_VDP))
    Q = np.diag([1.0, 1.0, 0.0, 0.0])
    R = np.eye(1) * 1e-2
    x0 = np.array([1.5, 0.0])
    mstate = jax_dmdc_from_operator(jmodel.A, 4, 4, jmodel.A.shape[1] - 4)
    config = m4q.MPCConfig(horizon=H_VDP, n_steps=STEPS_VDP, dt=DT, dim_u=1, order=1,
                           qp_backend=backend,
                           qp_params=JBoxQPParams(unroll=False))
    jplant = jc.VanDerPol(mu=MU, substeps=8)
    rj = m4q.mpc(jnp.asarray(x0), mstate, jplant, jnp.asarray(X_targ), jnp.asarray(U_targ),
                 jnp.asarray(Q), jnp.asarray(R), jnp.asarray(Q), config, sat=SAT_VDP,
                 key=jax.random.PRNGKey(0),
                 plant_step_fn=lambda p, x, u, dt: jc.rk4_simulate(p, x, u.reshape(-1, 1),
                                                                   dt)[:, -1],
                 lift_fn=lambda p, x: lift4(x), proj_fn=lambda p, z: z[:2])
    tconfig = tm.MPCConfig(horizon=H_VDP, n_steps=STEPS_VDP, dt=DT, dim_u=1, order=1,
                           qp_backend=backend)
    tmodel = dmdc_from_operator(T(jmodel.A), 4, 4, jmodel.A.shape[1] - 4)
    boxqp_small.launches = admm_big.launches = expm_small.launches = 0
    rt = tm.mpc(T(x0), tmodel, tc.VanDerPol(MU, device="cpu"), T(X_targ), T(U_targ), T(Q),
                T(R), T(Q), tconfig, SAT_VDP)
    assert boxqp_small.launches == admm_big.launches == expm_small.launches == 0
    assert int(rt.exit_code) == int(rj.exit_code) == 0
    assert rt.xs.dtype == torch.float64 and rt.xs.shape == (2, STEPS_VDP + 1)
    close(rt.us, rj.us, tol=LOOP)
    close(rt.xs, rj.xs, tol=LOOP)
    np.testing.assert_array_equal(N(rt.sqp_iters), np.asarray(rj.sqp_iters))
    assert float(rt.xs[:, -1].norm()) < 0.2


def test_vdp_batched_mpc_and_checkpoint(vdp_models, tmp_path):
    """batched_mpc on 6 initial states on the 1.5-radius circle (the card's
    phase at B 1024), each lane equal to its own mpc(); and the fleet runner
    on them, crashed after step 4 and resumed from its checkpoint, equal to
    the uninterrupted run."""
    _, (tmodel, _, _) = vdp_models
    steps = 12
    cfg = tm.MPCConfig(horizon=H_VDP, n_steps=steps, dt=DT, dim_u=1, order=1, qp_backend="ns")
    phase = np.linspace(0, 2 * np.pi, 6, endpoint=False)
    X0 = T(1.5 * np.stack([np.cos(phase), np.sin(phase)], axis=1))
    X_targ = torch.zeros(4, steps + H_VDP + 1, dtype=torch.float64)
    U_targ = torch.zeros(1, steps + H_VDP, dtype=torch.float64)
    Q = torch.diag(T([1.0, 1.0, 0.0, 0.0]))
    R = torch.eye(1, dtype=torch.float64) * 1e-2
    plants = tc.VanDerPol(MU, device="cpu")[None].param.expand(6)
    plants = dataclasses.replace(tc.VanDerPol(MU, device="cpu"), param=plants.clone())
    model = dmdc_from_operator(tmodel.A, 4, 4, tmodel.A.shape[1] - 4)
    res = tm.batched_mpc(X0, model, plants, X_targ, U_targ, Q, R, Q, cfg, SAT_VDP)
    for b in (0, 3):
        one = tm.mpc(X0[b], model, tc.VanDerPol(MU, device="cpu"), X_targ, U_targ, Q, R, Q,
                     cfg, SAT_VDP)
        close(res.us[b], N(one.us), tol=1e-12)
    runner = FleetRunner(cfg, SAT_VDP, warm_sqp_iters=(cfg.max_iter,), expm_taylor_k=None,
                         expm_max_squarings=None)
    args = (X0, model, plants, X_targ, U_targ, Q, R, Q)
    full = runner.run(*args, record=True)
    path = str(tmp_path / "vdp.npz")
    orig, calls = fleet_runner.advance, {"n": 0}

    def crashing(*a, **k):
        calls["n"] += 1
        if calls["n"] == 5:
            raise RuntimeError("simulated crash")
        return orig(*a, **k)

    fleet_runner.advance = crashing
    try:
        with pytest.raises(RuntimeError):
            runner.run(*args, record=True, checkpoint_path=path, checkpoint_every=2)
    finally:
        fleet_runner.advance = orig
    resumed = runner.run(*args, record=True, checkpoint_path=path, checkpoint_every=2)
    for key in ("final_x", "exit_code", "xs", "us", "objs"):
        assert torch.equal(resumed[key], full[key]), key
    assert resumed["xs"].dtype == torch.float64 and not os.path.exists(path)


# --------------------------------------------------------- real embedding

def test_embeddings_match_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 4)) + 1j * rng.normal(size=(3, 4))
    A = rng.normal(size=(4, 12)) + 1j * rng.normal(size=(4, 12))
    W = rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4))
    Q = W @ W.conj().T
    close(te.embed_vec(T(x)), je.embed_vec(x), tol=0)
    close(te.unembed_vec(te.embed_vec(T(x))), x, tol=0)
    close(te.embed_op(T(A[:, :4])), je.embed_op(A[:, :4]), tol=0)
    close(te.embed_stacked_model(T(A), 4), je.embed_stacked_model(A, 4), tol=0)
    close(te.embed_cost(T(Q)), je.embed_cost(Q), tol=0)
    close(te.embed_cost(T(Q.real)), je.embed_cost(Q.real), tol=0)
    e = rng.normal(size=4) + 1j * rng.normal(size=4)
    er = N(te.embed_vec(T(e)))
    assert abs(float(np.real(e.conj() @ Q @ e)) - float(er @ N(te.embed_cost(T(Q))) @ er)) < 1e-12


@pytest.fixture(scope="module")
def flagship_embedded():
    """The flagship problem (the JAX package's not_state preset) cut to 8
    steps on the kernel route, embedded by both packages; JAX's embedded
    mpc() (the Taylor plant step, its Newton-Schulz kernel route)."""
    sc_j = jpresets.not_state()
    cfg_j = dataclasses.replace(sc_j.config, n_steps=8, qp_backend="ns",
                                qp_params=JBoxQPParams(max_iter=30, n_rounds=2, unroll=False))
    prob_j, observe_j = je.embed_problem(np.asarray(sc_j.x0), np.asarray(sc_j.model.A),
                                         np.asarray(sc_j.X_targ), np.asarray(sc_j.Q),
                                         np.asarray(sc_j.Qf), dim_x=4)
    model_j = jax_dmdc_from_operator(jnp.asarray(prob_j.model_A), 8, 8,
                                     prob_j.model_A.shape[1] - 8)
    res_j = m4q.mpc(jnp.asarray(prob_j.x0), model_j, sc_j.plant, jnp.asarray(prob_j.X_targ),
                    sc_j.U_targ, jnp.asarray(prob_j.Q), sc_j.R, jnp.asarray(prob_j.Qf), cfg_j,
                    sat=sc_j.sat, du=sc_j.du, key=jax.random.PRNGKey(1),
                    plant_step_fn=prob_j.plant_step_fn, lift_fn=prob_j.lift_fn,
                    proj_fn=prob_j.proj_fn, observe_fn=observe_j)
    sc, _ = port_scenario(sc_j, jax.tree.map(lambda a: a[None], sc_j.plant), torch.float64)
    cfg = dataclasses.replace(sc.config, n_steps=8, qp_backend="ns",
                              qp_params=BoxQPParams(max_iter=30, n_rounds=2))
    return sc, cfg, prob_j, res_j


def test_embed_problem_matches_jax(flagship_embedded):
    sc, _, prob_j, _ = flagship_embedded
    prob, observe = te.embed_problem(sc.x0, sc.model.A, sc.X_targ, sc.Q, sc.Qf, dim_x=4,
                                     plant=sc.plant)
    assert observe is None and isinstance(prob.plant, te.EmbeddedPlant)
    for name in ("x0", "model_A", "X_targ", "Q", "Qf"):
        close(getattr(prob, name), getattr(prob_j, name), tol=0)
    carried = convert.embedded_from_numpy(*(getattr(prob_j, k) for k in
                                            ("x0", "model_A", "X_targ", "Q", "Qf")),
                                          plant=sc.plant, device="cpu")
    for name in ("x0", "model_A", "X_targ", "Q", "Qf"):
        torch.testing.assert_close(getattr(carried, name), getattr(prob, name), rtol=0, atol=0)


@pytest.mark.parametrize("e_ops", [None, PAULIS[1:]], ids=["full_state", "e_ops"])
def test_embed_problem_observe_fn_matches_jax(flagship_embedded, e_ops):
    """embed_problem(observe_fn=quantum_observe): the port's embedded
    observation (unembed the state and the 2 n_obs real draws, observe
    through the wrapped plant, embed) against JAX's observe_emb on the same
    state and the noise JAX drew from its key, with and without e_ops (the
    least-squares re-seed through three Paulis) and without noise."""
    sc, _, _, _ = flagship_embedded
    data = [N(t) for t in (sc.x0, sc.model.A, sc.X_targ, sc.Q, sc.Qf)]
    _, observe_j = je.embed_problem(*data, dim_x=4, observe_fn=jq.quantum_observe)
    _, observe = te.embed_problem(sc.x0, sc.model.A, sc.X_targ, sc.Q, sc.Qf, dim_x=4,
                                  observe_fn=tq.quantum_observe)
    kw = dict(sigma=1e-2, e_ops=e_ops)
    plant_j = jq.QuantumPlant.create(0.1 * PAULIS[3], [0.5 * PAULIS[1]], **kw)
    plant = te.EmbeddedPlant(tq.QuantumPlant.create(0.1 * PAULIS[3], [0.5 * PAULIS[1]],
                                                    device="cpu", **kw)[None])
    rng = np.random.default_rng(11)
    psi = rng.normal(size=2) + 1j * rng.normal(size=2)
    psi /= np.linalg.norm(psi)
    x = np.outer(psi, psi.conj()).reshape(-1)
    key = jax.random.PRNGKey(3)
    n_obs = 4 if e_ops is None else len(e_ops)
    assert plant.n_obs == 2 * n_obs
    draws = jax.random.normal(key, (n_obs,), jnp.float64) \
        + 1j * jax.random.normal(jax.random.fold_in(key, 1), (n_obs,), jnp.float64)
    xe = te.embed_vec(T(x))[None]
    for noise_j, noise in ((key, te.embed_vec(T(draws))[None]), (None, None)):
        got = observe(plant, xe, noise)
        assert got.shape == (1, 8) and got.dtype == torch.float64
        close(got[0], observe_j(plant_j, je.embed_vec(x), noise_j))
    assert float((observe(plant, xe, te.embed_vec(T(draws))[None]) - xe).abs().max()) > 1e-3


def test_embedded_mpc_matches_complex_and_jax(flagship_embedded):
    """The embedded mpc() on the kernel route against the port's complex
    mpc() (equal to rounding) and against JAX's embedded run (us 1e-6,
    x_final 1e-8, its own bars between its embedded and complex runs)."""
    sc, cfg, _, res_j = flagship_embedded
    prob, _ = te.embed_problem(sc.x0, sc.model.A, sc.X_targ, sc.Q, sc.Qf, dim_x=4,
                               plant=sc.plant)
    model_e = dmdc_from_operator(prob.model_A, 8, 8, prob.model_A.shape[1] - 8)
    res_c = tm.mpc(sc.x0, sc.model, sc.plant, sc.X_targ, sc.U_targ, sc.Q, sc.R, sc.Qf, cfg,
                   sc.sat, sc.du)
    res_e = tm.mpc(prob.x0, model_e, prob.plant, prob.X_targ, sc.U_targ, prob.Q, sc.R, prob.Qf,
                   cfg, sc.sat, sc.du)
    assert int(res_e.exit_code) == int(res_c.exit_code) == int(res_j.exit_code) == 0
    assert res_e.xs.dtype == torch.float64 and res_e.xs.shape == (8, 9)
    close(res_e.us, N(res_c.us))
    close(te.unembed_vec(res_e.xs.T).T, N(res_c.xs))
    close(res_e.us, res_j.us, tol=1e-6)
    close(te.unembed_vec(res_e.xs[:, -1]), np.asarray(je.unembed_vec(res_j.xs[:, -1])),
          tol=1e-8)
    assert float(np.abs(N(res_e.us)).max()) > 0.01 and float(res_e.xs[3, -1]) > 0.5


def test_embedded_fleet_noise_and_no_streaming(flagship_embedded):
    """batched_mpc on 4 detuned embedded lanes with measurement noise: the
    runner's default observation adds real noise to the embedded vector,
    which is the complex loop's noise [Re; Im] - the lanes equal the complex
    fleet's with the same draws. A streaming refit is refused."""
    sc, cfg, _, _ = flagship_embedded
    prob, _ = te.embed_problem(sc.x0, sc.model.A, sc.X_targ, sc.Q, sc.Qf, dim_x=4)
    model_e = dmdc_from_operator(prob.model_A, 8, 8, prob.model_A.shape[1] - 8)
    plants = make_scenario_batch(dataclasses.replace(sc.plant, sigma=torch.tensor(1e-4,
                                 dtype=torch.float64)), 4)
    g = torch.Generator().manual_seed(7)
    re_, im_ = (torch.randn((8, 4, 4), generator=g, dtype=torch.float64) for _ in range(2))
    res_c = tm.batched_mpc(sc.x0, sc.model, plants, sc.X_targ, sc.U_targ, sc.Q, sc.R, sc.Qf,
                           cfg, sc.sat, sc.du, noise=torch.complex(re_, im_))
    emb = te.EmbeddedPlant(plants)
    res_e = tm.batched_mpc(prob.x0, model_e, emb, prob.X_targ, sc.U_targ, prob.Q, sc.R,
                           prob.Qf, cfg, sc.sat, sc.du, noise=torch.cat([re_, im_], dim=-1))
    close(res_e.us, N(res_c.us))
    close(te.unembed_vec(res_e.xs.transpose(1, 2)).transpose(1, 2), N(res_c.xs))
    # a generator draws real noise for a real state
    res_g = tm.batched_mpc(prob.x0, model_e, emb, prob.X_targ, sc.U_targ, prob.Q, sc.R,
                           prob.Qf, cfg, sc.sat, sc.du, generator=torch.Generator().manual_seed(1))
    assert res_g.xs.dtype == torch.float64 and bool(torch.isfinite(res_g.xs).all())
    streaming = dataclasses.replace(cfg, streaming=True)
    with pytest.raises(ValueError, match="streaming"):
        tm.batched_mpc(prob.x0, model_e, emb, prob.X_targ, sc.U_targ, prob.Q, sc.R, prob.Qf,
                       streaming, sc.sat, sc.du, noise=torch.cat([re_, im_], dim=-1),
                       model_update_fn=online_fit_iteration)
