"""The port's learned-model loop against the JAX package, on the CPU: the
DMDc model layer (DiscrepDMDc, OnlineDMDc, HistoryState), `train_model`,
`quantum_simulate` / `quantum_observe`, per-lane operators in the
linearization, the streaming + noisy + recorded fleet, `mpc()`, `trim` and
the step clock. Inputs are made from numpy seeds (or by the JAX package's
own constructors) and carried across as numpy.

Noise: the JAX loop draws its observation noise from per-lane keys, at
every step, measurement or not (key, k = split(key); normal(k) +
1j normal(fold_in(k, 1))); `jax_noise` rebuilds that stream and hands it to
the port as its `noise` tensor, indexed by step. `quantum_simulate` splits
its key into (kr, ki) instead.

Tolerances: the model layer, the simulator and the observation 1e-10 in
float64 (measured 1e-15 .. 1e-13); the streaming fleet 1e-8 on states,
controls, objectives and each lane's refit A (measured 3.8e-11 on the
states, 2.3e-11 on A), iterations, n_valid and exit codes equal. float32
RLS: over the full 20 steps at sigma 1e-5 the port's float32 fleet ends
within 1e-4 of its float64 run in per-lane fidelity (measured 4.5e-5 on
these 4 lanes) and its refit A within 2e-3 (measured 3.4e-4): the state
gap stays at ~4e-7 over steps 1-8, then grows with the updates to 5.6e-4
at step 20 (P loses symmetry in float32), and the fidelity gap stays
below the bound. `mpc()` against
JAX `mpc()`, both on the adaptive Cholesky box-QP (the default backend),
lane-exact: 1e-8 on states, controls, objectives and the refit A, SQP
iterations, n_valid and exit codes equal (measured 4.8e-12 on the states,
although JAX steps its plant by Pade and the port by the Taylor expm);
the port's `mpc()` on the kernel route (qp_backend="ns") against the JAX
host loop configured as that route runs, lane-exact to 1e-8.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import mpc4quantum_tpu as m4q
from mpc4quantum_tpu import presets as jpresets
from mpc4quantum_tpu.models import dmdc as jd
from mpc4quantum_tpu.models.training import train_model as jax_train
from mpc4quantum_tpu.mpc import clock as jclock
from mpc4quantum_tpu.mpc.driver import MPCResult as JaxResult, trim as jax_trim
from mpc4quantum_tpu.mpc.hostloop import HostLoopMPC
from mpc4quantum_tpu.ops import expm as jexpm
from mpc4quantum_tpu.ops.bilinear import BilinearModel as JBilinear, model_along_traj as jmat
from mpc4quantum_tpu.parallel.fleet import make_scenario_batch as jax_batch
from mpc4quantum_tpu.plants import quantum as jq

import mpc4quantum_tpu_torch as tm
from mpc4quantum_tpu_torch import systems as tsystems
from mpc4quantum_tpu_torch.benchfleet import fleet_fidelity, run_hostloop_fleet
from mpc4quantum_tpu_torch.convert import model_from_numpy, plant_from_numpy, scenario_from_numpy
from mpc4quantum_tpu_torch.kernels.boxqp import boxqp_small
from mpc4quantum_tpu_torch.kernels.expm import expm_small
from mpc4quantum_tpu_torch.models import dmdc as td
from mpc4quantum_tpu_torch.mpc import clock as tclock
from mpc4quantum_tpu_torch.ops import expm as texpm
from mpc4quantum_tpu_torch.ops.bilinear import BilinearModel as TBilinear, model_along_traj
from mpc4quantum_tpu_torch.ops.library import control_powers, lift_controls
from mpc4quantum_tpu_torch.plants import quantum as tq
from mpc4quantum_tpu_torch.utils.linalg import pinv

EXACT = 1e-10
FLEET = 1e-8
B = 4
SIGMA = 1e-5
PAULIS = [np.eye(2, dtype=complex), tsystems.SX, tsystems.SY, tsystems.SZ]


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


def crandn(rng, *shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def jax_noise(keys, n_steps, n):
    """(n_steps, B, n) complex: the observation noise the JAX loop draws
    from per-lane keys (B, 2)."""
    keys = jnp.asarray(keys)
    split = jax.vmap(jax.random.split)
    re = jax.vmap(lambda k: jax.random.normal(k, (n,), jnp.float64))
    im = jax.vmap(lambda k: jax.random.normal(jax.random.fold_in(k, 1), (n,), jnp.float64))
    out = []
    for _ in range(n_steps):
        pair = split(keys)
        keys, k = pair[:, 0], pair[:, 1]
        out.append(np.asarray(re(k)) + 1j * np.asarray(im(k)))
    return np.stack(out)


def fields_of(model):
    """A JAX model's dataclass fields as numpy (nested for HistoryState)."""
    out = {}
    for f in dataclasses.fields(model):
        v = getattr(model, f.name)
        out[f.name] = fields_of(v) if dataclasses.is_dataclass(v) else (
            None if v is None else np.asarray(v))
    return out


# ---------------------------------------------------------------------------
# model layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rtol", [None, 1e-15, 1e-2, 0.5])
def test_pinv_cuts_as_jax(rtol):
    rng = np.random.default_rng(0)
    a = crandn(rng, 3, 6, 3) @ crandn(rng, 3, 3, 9)  # rank 3 of 6
    a[1] *= np.linspace(1e-6, 1, 9)                   # spread singular values
    close(pinv(T(a), rtol), jnp.linalg.pinv(jnp.asarray(a), rtol=rtol), 1e-9)
    bad = a.copy()
    bad[2, 0, 0] = np.nan
    p = pinv(T(bad), rtol)
    assert bool(torch.isnan(p[2]).all()) and bool(torch.isfinite(p[:2]).all())


def test_discrep_matches_jax():
    rng = np.random.default_rng(1)
    dim_y, dim_x, dim_u, n = 4, 4, 8, 15
    Y, X, U = crandn(rng, dim_y, n), crandn(rng, dim_x, n), crandn(rng, dim_u, n)
    for cap in (None, 12, 20):
        t, j = td.discrep_from_data(T(Y), T(X), T(U), rcond=1e-3, capacity=cap), \
            jd.discrep_from_data(Y, X, U, rcond=1e-3, capacity=cap)
        for k in ("A", "Y", "X", "U", "count"):
            close(getattr(t, k), getattr(j, k))
        assert t.capacity == j.capacity
    t, j = td.discrep_append(t, T(Y[:, :3]), T(X[:, :3]), T(U[:, :3])), \
        jd.discrep_append(j, Y[:, :3], X[:, :3], U[:, :3])
    close(t.X, j.X)
    close(t.count, j.count)
    # streaming from a bootstrap: the rank gate holds the correction until
    # X has rank dim_x, then A moves every update
    A0 = crandn(rng, dim_y, dim_x + dim_u)
    t = td.discrep_bootstrap(T(A0), dim_y, dim_x, dim_u, capacity=12, discount=0.9, rcond=1e-12)
    j = jd.discrep_bootstrap(A0, dim_y, dim_x, dim_u, capacity=12, discount=0.9, rcond=1e-12)
    moved = []
    for i in range(14):
        t = td.discrep_fit_iteration(t, T(Y[:, i]), T(X[:, i]), T(U[:, i]))
        j = jd.discrep_fit_iteration(j, Y[:, i], X[:, i], U[:, i])
        for k in ("A", "Y", "X", "U", "count"):
            close(getattr(t, k), getattr(j, k), 1e-9)
        moved.append(float(np.abs(N(t.A) - A0).max()) > 0)
    assert moved[:3] == [False] * 3 and all(moved[3:])
    # a lane batch equals its lanes run one by one
    tb = td.tile_lanes(td.discrep_bootstrap(T(A0), dim_y, dim_x, dim_u, capacity=12), 3)
    for i in range(6):
        tb = td.discrep_fit_iteration(tb, T(np.stack([Y[:, i], X[:, i], Y[:, i + 1]])),
                                      T(np.stack([X[:, i], Y[:, i], X[:, i + 1]])),
                                      T(np.stack([U[:, i], U[:, i + 1], U[:, i + 2]])))
    one = td.discrep_bootstrap(T(A0), dim_y, dim_x, dim_u, capacity=12)
    for i in range(6):
        one = td.discrep_fit_iteration(one, T(X[:, i]), T(Y[:, i]), T(U[:, i + 1]))
    close(tb.A[1], N(one.A), 1e-12)


def test_online_matches_jax():
    rng = np.random.default_rng(2)
    dim_y, dim_x, dim_u, n = 4, 4, 8, 30
    Y, X, U = crandn(rng, dim_y, n), crandn(rng, dim_x, n), crandn(rng, dim_u, n)
    t, j = td.online_from_data(T(Y), T(X), T(U), discount=0.95), \
        jd.online_from_data(Y, X, U, discount=0.95)
    close(t.A, j.A, 1e-9)
    close(t.P, j.P, 1e-9)
    A0 = crandn(rng, dim_y, dim_x + dim_u)
    t = td.online_from_bootstrap(T(A0), dim_y, dim_x, dim_u, alpha=1e2, discount=0.95)
    j = jd.online_from_bootstrap(A0, dim_y, dim_x, dim_u, alpha=1e2, discount=0.95)
    for i in range(10):
        t = td.online_fit_iteration(t, T(Y[:, i]), T(X[:, i]), T(U[:, i]))
        j = jd.online_fit_iteration(j, Y[:, i], X[:, i], U[:, i])
        close(t.A, j.A)
        close(t.P, j.P, 1e-8)
    # the plain transpose, not the Hermitian form: a complex model's P
    # becomes complex symmetric, not Hermitian
    assert float(np.abs(N(t.P) - N(t.P).T).max()) < 1e-9
    assert float(np.abs(N(t.P) - N(t.P).conj().T).max()) > 1e-3
    # a lane batch equals its lanes run one by one
    tb = td.tile_lanes(td.online_from_bootstrap(T(A0), dim_y, dim_x, dim_u), 2)
    one = td.online_from_bootstrap(T(A0), dim_y, dim_x, dim_u)
    for i in range(5):
        tb = td.online_fit_iteration(tb, T(np.stack([Y[:, i], Y[:, i + 5]])),
                                     T(np.stack([X[:, i], X[:, i + 5]])),
                                     T(np.stack([U[:, i], U[:, i + 5]])))
        one = td.online_fit_iteration(one, T(Y[:, i + 5]), T(X[:, i + 5]), T(U[:, i + 5]))
    close(tb.A[1], N(one.A), 1e-12)
    close(tb.P[1], N(one.P), 1e-12)


def test_history_matches_jax():
    rng = np.random.default_rng(3)
    Y, X, U = crandn(rng, 4, 12), crandn(rng, 4, 12), crandn(rng, 8, 12)
    A0 = crandn(rng, 4, 12)
    t = td.with_history(td.online_from_bootstrap(T(A0), 4, 4, 8), n_slots=3, every=2)
    j = jd.with_history(jd.online_from_bootstrap(A0, 4, 4, 8), n_slots=3, every=2)
    tf, jf = td.history_update(td.online_fit_iteration), jd.history_update(jd.online_fit_iteration)
    for i in range(9):
        t, j = tf(t, T(Y[:, i]), T(X[:, i]), T(U[:, i])), jf(j, Y[:, i], X[:, i], U[:, i])
        close(t.buf, j.buf)
        close(t.pbuf, j.pbuf, 1e-8)
        assert (int(t.n_recorded), int(t.it)) == (int(j.n_recorded), int(j.it))
    # the ring wrapped (5 snapshots in 3 slots): A0 and the last two survive
    ts, js = td.history_snapshots(t), jd.history_snapshots(j)
    assert len(ts) == len(js) == 3
    for a, b in zip(ts, js):
        close(a, b)
    for a, b in zip(td.history_p_snapshots(t), jd.history_p_snapshots(j)):
        close(a, b, 1e-8)
    close(ts[0], A0, 0.0)
    with pytest.raises(ValueError, match="n_slots"):
        td.with_history(t.inner, n_slots=1)
    wrapped = td.with_history(td.discrep_bootstrap(T(A0), 4, 4, 8, capacity=6), n_slots=2)
    with pytest.raises(ValueError, match="no RLS state"):
        td.history_p_snapshots(wrapped)


def test_random_bootstraps_draw_from_the_generator():
    g = lambda: torch.Generator().manual_seed(5)
    a, b = td.online_from_randn(g(), 4, 4, 8, sigma=0.1), td.online_from_randn(g(), 4, 4, 8, sigma=0.1)
    assert a.A.shape == (4, 12) and torch.equal(a.A, b.A) and torch.equal(a.P, 1e2 * torch.eye(12,
                                                                                 dtype=a.P.dtype))
    assert 0.05 < float(a.A.std()) < 0.2
    d = td.discrep_from_randn(g(), 4, 4, 8, sigma=0.1, capacity=6)
    assert torch.equal(d.A, a.A) and d.X.shape == (4, 6) and int(d.count) == 0


def test_convert_carries_jax_models_and_e_ops_plants():
    rng = np.random.default_rng(4)
    A0 = crandn(rng, 4, 12)
    Y, X, U = crandn(rng, 4, 3), crandn(rng, 4, 3), crandn(rng, 8, 3)
    online = jd.online_fit_iteration(jd.online_from_bootstrap(A0, 4, 4, 8), Y[:, 0], X[:, 0],
                                     U[:, 0])
    discrep = jd.discrep_fit_iteration(jd.discrep_bootstrap(A0, 4, 4, 8, capacity=5), Y[:, 0],
                                       X[:, 0], U[:, 0])
    hist = jd.history_update(jd.online_fit_iteration)(jd.with_history(
        jd.online_from_bootstrap(A0, 4, 4, 8), n_slots=2, every=1), Y[:, 1], X[:, 1], U[:, 1])
    for j, kind in ((online, td.OnlineDMDc), (discrep, td.DiscrepDMDc), (hist, td.HistoryState)):
        t = model_from_numpy(fields_of(j), device="cpu")
        assert type(t) is kind
        close(t.A, j.A, 0.0)
    t = model_from_numpy(fields_of(hist), device="cpu")
    close(t.pbuf, hist.pbuf, 0.0)
    assert (t.every, t.inner.dim_u, int(t.n_recorded)) == (1, 8, 2)
    assert model_from_numpy(fields_of(discrep), device="cpu", dtype=torch.float32).A.dtype \
        == torch.complex64
    jp = jq.QuantumPlant.create(0.1 * tsystems.SZ, [0.5 * tsystems.SX], sigma=1e-4, e_ops=PAULIS)
    tp = plant_from_numpy({k: np.asarray(getattr(jp, k)) for k in
                           ("H0", "H1s", "sigma", "e_obs", "e_dual")})
    close(tp.e_dual, jp.e_dual, 0.0)
    assert tp.n_obs == 4
    assert plant_from_numpy({"H0": jp.H0, "H1s": jp.H1s, "sigma": jp.sigma,
                             "e_obs": None}).e_obs is None


# ---------------------------------------------------------------------------
# plants and ops
# ---------------------------------------------------------------------------


def test_plant_walkers_keep_none_fields():
    from mpc4quantum_tpu_torch.parallel.fleet import make_scenario_batch

    p = tq.QuantumPlant.create(0.1 * tsystems.SZ, [0.5 * tsystems.SX], sigma=1e-3,
                               device="cpu")
    assert p.e_obs is None and "e_obs" not in p.tensor_fields() and p.n_obs == 4
    lanes = make_scenario_batch(p, 3)
    assert lanes.e_obs is None and lanes.lanes == 3 and lanes[1:].lanes == 2
    assert lanes.to("cpu", torch.float32).e_dual is None
    pe = tq.QuantumPlant.create(0.1 * tsystems.SZ, [0.5 * tsystems.SX], e_ops=PAULIS[:2],
                                device="cpu")
    lanes = make_scenario_batch(pe, 3, dtype=torch.float32)
    assert lanes.e_obs.shape == (3, 2, 4) and lanes.e_dual.dtype == torch.complex64
    assert lanes.n_obs == 2 and pe[None].lanes == 1


@pytest.mark.parametrize("interp", ["zoh", "linear"])
@pytest.mark.parametrize("e_ops", [False, True])
@pytest.mark.parametrize("noisy", [False, True])
def test_quantum_simulate_matches_jax(interp, e_ops, noisy):
    rng = np.random.default_rng(6)
    H0, H1 = 0.3 * tsystems.SZ, 0.5 * tsystems.SX
    kw = dict(sigma=1e-3, e_ops=PAULIS[1:] if e_ops else None)
    jp = jq.QuantumPlant.create(H0, [H1], **kw)
    tp = tq.QuantumPlant.create(H0, [H1], **kw, device="cpu")
    us = rng.uniform(-1, 1, size=(1, 12))
    x0 = np.diag([1.0, 0.0]).astype(complex).flatten()
    key = jax.random.PRNGKey(7) if noisy else None
    xj = np.asarray(jq.quantum_simulate(jp, jnp.asarray(x0), jnp.asarray(us), 0.25, key=key,
                                        interp=interp, substeps=4))
    noise = None
    if noisy:
        kr, ki = jax.random.split(key)
        noise = T(np.asarray(jax.random.normal(kr, xj.shape, jnp.float64))
                  + 1j * np.asarray(jax.random.normal(ki, xj.shape, jnp.float64)))
    expm_small.launches = 0
    xt = tq.quantum_simulate(tp, T(x0), T(us), 0.25, noise=noise, interp=interp, substeps=4)
    assert xt.shape == xj.shape == ((3 if e_ops else 4), 13)
    close(xt, xj)
    assert expm_small.launches == 0  # the plain version ran on the CPU


def test_quantum_observe_matches_jax():
    rng = np.random.default_rng(8)
    x = crandn(rng, 3, 4)
    noise = crandn(rng, 3, 4)
    for e_ops in (None, PAULIS, PAULIS[:2]):
        jp = jq.QuantumPlant.create(0.1 * tsystems.SZ, [0.5 * tsystems.SX], sigma=1e-2,
                                    e_ops=e_ops)
        tp = plant_from_numpy({k: None if getattr(jp, k) is None else np.asarray(getattr(jp, k))
                               for k in ("H0", "H1s", "sigma", "e_obs", "e_dual")})
        lanes = tp[None][[0, 0, 0]]
        n_obs = tp.n_obs
        # JAX: one lane at a time, its noise as the key would draw it - here
        # the same numbers through the observation's arithmetic
        for b in range(3):
            ref = (x[b] + 1e-2 * noise[b]) if e_ops is None else \
                np.asarray(jp.e_dual) @ (np.asarray(jp.e_obs) @ x[b] + 1e-2 * noise[b, :n_obs])
            close(tq.quantum_observe(lanes, T(x), T(noise[:, :n_obs]))[b], ref)
        if e_ops is not None:
            close(tq.quantum_expectations(lanes, T(x)), (np.asarray(jp.e_obs) @ x.T).T)
            close(tq.quantum_observe(lanes, T(x)),
                  np.asarray(jax.vmap(lambda v: jq.quantum_observe(jp, v))(jnp.asarray(x))))
    # with a key, the JAX observation draws the noise the port takes as data
    jp = jq.QuantumPlant.create(0.1 * tsystems.SZ, [0.5 * tsystems.SX], sigma=1e-2, e_ops=PAULIS)
    k = jax.random.PRNGKey(9)
    nz = np.asarray(jax.random.normal(k, (4,), jnp.float64)) + 1j * np.asarray(
        jax.random.normal(jax.random.fold_in(k, 1), (4,), jnp.float64))
    tp = tq.QuantumPlant.create(0.1 * tsystems.SZ, [0.5 * tsystems.SX], sigma=1e-2, e_ops=PAULIS,
                                device="cpu")
    close(tq.quantum_observe(tp[None], T(x[:1]), T(nz[None]))[0],
          jq.quantum_observe(jp, jnp.asarray(x[0]), k))


def test_propagators_match_jax():
    rng = np.random.default_rng(10)
    H0, H1s = 0.2 * tsystems.SZ, np.stack([0.5 * tsystems.SX, 0.5 * tsystems.SY])
    us = rng.uniform(-1, 1, size=(2, 7))
    close(texpm.step_generators(T(H0), T(H1s), T(us)), jexpm.step_generators(H0, H1s, us))
    for herm in (True, False):
        close(texpm.propagators_from_controls(T(H0), T(H1s), T(us), 0.3, herm),
              jexpm.propagators_from_controls(H0, H1s, us, 0.3, herm))
    # norms past the unscaled range take squarings
    big = texpm.propagators_from_controls(T(H0), T(H1s), T(30 * us), 0.3)
    close(big, jexpm.propagators_from_controls(H0, H1s, 30 * us, 0.3), 1e-9)


def test_per_lane_operators_in_the_linearization():
    rng = np.random.default_rng(11)
    dim_x, H, Bn = 4, 5, 3
    A_ops = crandn(rng, Bn, dim_x, dim_x * 3) * 0.3
    X, U = crandn(rng, Bn, dim_x, H), rng.uniform(-1, 1, size=(Bn, 1, H))
    lanes = TBilinear.from_stacked(T(A_ops[:, :, :dim_x]), T(A_ops[:, :, dim_x:]), 1, 2)
    got = model_along_traj(lanes, T(X), T(U))
    for b in range(Bn):
        one = TBilinear.from_stacked(T(A_ops[b, :, :dim_x]), T(A_ops[b, :, dim_x:]), 1, 2)
        ref = model_along_traj(one, T(X[b:b + 1]), T(U[b:b + 1]))
        jref = jmat(JBilinear.from_stacked(A_ops[b, :, :dim_x], A_ops[b, :, dim_x:], 1, 2),
                    jnp.asarray(X[b]), jnp.asarray(U[b]))
        for g, r, j in zip(got, ref, jref):
            close(g[b], N(r[0]), 1e-13)
            close(g[b], np.asarray(j), EXACT)
    # predict through lane b's operator
    m = td.dmdc_from_operator(T(A_ops), dim_x, dim_x, 2 * dim_x)
    xs, us_ = crandn(rng, dim_x, Bn), crandn(rng, 2 * dim_x, Bn)
    y = td.predict(m, T(xs), T(us_))
    for b in range(Bn):
        close(y[:, b], A_ops[b] @ np.concatenate([xs[:, b], us_[:, b]]), 1e-13)


def test_train_model_matches_jax():
    dt, order = 0.25, 2
    ts = np.arange(0, 12.0, dt)
    us = tsystems.blackman(ts, 0, 6.0, dt)[None, :]
    jplant = jq.QuantumPlant.create(0.0 * tsystems.SZ, [0.5 * tsystems.SX])
    tplant = tq.QuantumPlant.create(0.0 * tsystems.SZ, [0.5 * tsystems.SX], device="cpu")
    rho0 = np.diag([1.0, 0.0]).astype(complex).flatten()
    xj = np.asarray(jq.quantum_simulate(jplant, jnp.asarray(rho0), jnp.asarray(us), dt))
    xt = tq.quantum_simulate(tplant, T(rho0), T(us), dt)
    close(xt, xj)
    powers = control_powers(order, 1)[1:]
    UL1 = lift_controls(T(us), powers)
    mt, rt, lt = tm.train_model(xt[:, 1:], xt[:, :-1], UL1)
    mj, rj, lj = jax_train(jnp.asarray(xj[:, 1:]), jnp.asarray(xj[:, :-1]), jnp.asarray(N(UL1)))
    np.testing.assert_allclose(N(lt), np.asarray(lj), rtol=1e-6, atol=1e-12)
    assert rt == float(rj) and float(lt.min()) < 1e-3
    close(mt.A, mj.A, 1e-9)
    assert (int(mt.count), mt.capacity) == (int(mj.count), mj.capacity)


def test_step_clock_matches_jax():
    for args in ((0.25, 10, 20, 1), (1.0, 5, 12, 3)):
        t, j = tclock.StepClock(*args), jclock.StepClock(*args)
        np.testing.assert_array_equal(t.ts, j.ts)
        np.testing.assert_array_equal(t.ts_step(4), j.ts_step(4))
        np.testing.assert_array_equal(t.ts_horizon(4), j.ts_horizon(4))
        assert t.to_string() == j.to_string()
    for v in (0.25, 1e-4, 3, -2.5e7):
        assert tclock.val_to_str(v) == jclock.val_to_str(v)


# ---------------------------------------------------------------------------
# the streaming + noisy + recorded fleet
# ---------------------------------------------------------------------------


def port_scenario(sc, plants, dtype, streaming=False):
    c, qp = sc.config, sc.config.qp_params
    config = dict(horizon=c.horizon, n_steps=c.n_steps, dt=c.dt, dim_u=c.dim_u, order=c.order,
                  measure_freq=c.measure_freq, warm_start=c.warm_start, step_tol=c.step_tol,
                  max_iter=c.max_iter, streaming=streaming,
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


def jax_host_loop(sc, warm_sqp_iters, model_update_fn=None, observe_fn=None):
    """The JAX host loop with the port's cold form: every QP at the
    scenario's own budget with the Gauss-Jordan K-inverse and no carried
    duals, the plant step's Taylor 12 expm unscaled (the auto budget on
    these plants). The ADMM chain in its scan form (`unroll=False`, the
    same iterates): the unrolled 2x150 chain takes minutes to compile."""
    import functools

    cfg = dataclasses.replace(sc.config, qp_backend="ns",
                              qp_params=sc.config.qp_params.replace(kinv="gj", unroll=False))
    return HostLoopMPC(cfg, sc.sat, du=sc.du, exit_condition=sc.exit_condition,
                       plant_step_fn=functools.partial(jq.quantum_step_taylor, fixed_squarings=0,
                                                       order=12),
                       model_update_fn=model_update_fn, observe_fn=observe_fn,
                       warm_sqp_iters=warm_sqp_iters, granularity="mixed")


@pytest.fixture(scope="module")
def streaming_reference():
    """The JAX host loop's streaming fleet: not_state, B = 4, a per-lane
    OnlineDMDc bootstrapped from the analytic operator, noise at sigma
    1e-5, recorded (about 8 s)."""
    sc = jpresets.not_state()
    m0 = jd.online_from_bootstrap(sc.model.A, 4, 4, sc.model.A.shape[1] - 4, alpha=1e2)
    sc = dataclasses.replace(sc, model=m0,
                             config=dataclasses.replace(sc.config, streaming=True))
    plants, keys = jax_batch(jax.random.PRNGKey(1), sc.plant, B, detune_scale=0.01)
    plants = plants.replace(sigma=plants.sigma + SIGMA)
    runner = jax_host_loop(sc, (7, 1), model_update_fn=jd.online_fit_iteration)
    a = np.asarray
    out = runner.run(sc.x0, jax.tree.map(a, m0), jax.tree.map(a, plants), a(sc.X_targ),
                     a(sc.U_targ), a(sc.Q), a(sc.R), a(sc.Qf), a(keys), record=True)
    return sc, plants, out, jax_noise(keys, sc.config.n_steps, 4)


def run_port_streaming(reference, dtype):
    sc_j, plants_j, _, noise = reference
    sc, plants = port_scenario(sc_j, plants_j, dtype, streaming=True)
    A = sc.model.A
    sc = dataclasses.replace(sc, model=td.online_from_bootstrap(A, 4, 4, A.shape[1] - 4,
                                                                alpha=1e2))
    return sc, run_hostloop_fleet(sc, B, plants=plants, record=True, noise=T(noise),
                                  model_update_fn=td.online_fit_iteration)


def test_streaming_noisy_fleet_float64_matches_jax(streaming_reference):
    _, _, out_j, _ = streaming_reference
    boxqp_small.launches = expm_small.launches = 0
    sc, (m, out) = run_port_streaming(streaming_reference, torch.float64)
    close(out["xs"], out_j["xs"], FLEET)
    close(out["us"], out_j["us"], FLEET)
    close(out["objs"], out_j["objs"], FLEET)
    np.testing.assert_array_equal(N(out["sqp_iters"]), out_j["sqp_iters"])
    np.testing.assert_array_equal(N(out["n_valid"]), out_j["n_valid"])
    np.testing.assert_array_equal(N(out["exit_code"]), out_j["exit_code"])
    close(out["model_state"].A, out_j["model_state"].A, FLEET)
    close(out["model_state"].P, out_j["model_state"].P, 1e-6)
    assert out["xs"].shape == (B, 4, 21) and out["us"].shape == (B, 1, 20)
    assert m["completed_frac"] == 1.0 and m["fidelity_min"] > 0.99
    # the refit moved every lane's operator, and the lanes differ
    dA = (out["model_state"].A - sc.model.A).abs().amax(dim=(1, 2))
    assert bool((dA > 1e-10).all())
    assert float((out["model_state"].A[0] - out["model_state"].A[1]).abs().max()) > 1e-8
    assert boxqp_small.launches == 0 and expm_small.launches == 0


def test_streaming_noisy_fleet_float32_tracks_float64(streaming_reference):
    sc64, (_, out64) = run_port_streaming(streaming_reference, torch.float64)
    sc32, (_, out32) = run_port_streaming(streaming_reference, torch.float32)
    assert out32["xs"].dtype == torch.complex64
    dfid = np.abs(fleet_fidelity(sc32, out32["final_x"]) - fleet_fidelity(sc64, out64["final_x"]))
    assert float(dfid.max()) < 1e-4, dfid
    dA = float((out32["model_state"].A.to(torch.complex128) - out64["model_state"].A).abs().max())
    assert dA < 2e-3, dA
    np.testing.assert_array_equal(N(out32["exit_code"]), N(out64["exit_code"]))


def test_noise_and_generator_contract():
    sc = tm.presets.not_state(device="cpu")
    from mpc4quantum_tpu_torch.parallel.fleet import make_scenario_batch
    plants = make_scenario_batch(sc.plant, 2)
    noisy = dataclasses.replace(plants, sigma=plants.sigma + SIGMA)
    with pytest.raises(ValueError, match="shape"):
        run_hostloop_fleet(sc, 2, plants=noisy, noise=torch.zeros(3, 2, 4, dtype=torch.complex128))
    g = lambda: torch.Generator().manual_seed(4)
    _, a = run_hostloop_fleet(sc, 2, plants=noisy, generator=g(), record=True)
    _, b = run_hostloop_fleet(sc, 2, plants=noisy, generator=g(), record=True)
    _, c = run_hostloop_fleet(sc, 2, plants=plants, record=True)
    assert torch.equal(a["xs"], b["xs"])
    assert 1e-7 < float((a["xs"] - c["xs"]).abs().max()) < 1e-3


# Settings the card's gated cells leave out, run through the JAX host loop
# and the port on the same lanes (jax_batch of PRNGKey(1)) and the same
# noise: (model kind, lanes, QP budget, rcond of the discrepancy fit). The
# online cases run their lanes twice, noiseless and then at sigma 1e-4
# (the JAX noisy tests' scale), in one batch; "3x15" is the JAX bench's
# forced-cold budget (run_hostloop_fleet(warm_duals=False)), "2x150" the
# port's streaming rule (the scenario's own budget, every QP cold).
WITNESS = {"online_2x150": ("online", 64, (2, 150), None),
           "online_3x15": ("online", 64, (3, 15), None),
           "discrep_rcond_1e-15": ("discrep", 256, (2, 150), 1e-15)}


@pytest.mark.parametrize("case", list(WITNESS))
def test_reference_loses_the_same_lanes(case):
    """The lanes the JAX loop loses are the lanes the port loses.

    Measured in float64 (JAX / port, the port within 7e-8 of JAX in
    fidelity on every lane):
      - online, 2x150: noiseless min 0.99652; at sigma 1e-4 mean 0.98712,
        min 0.67781, lanes 9, 10, 20 and 60 of 64 at or below 0.95, no QP
        failure;
      - online, 3x15: noiseless min 0.99428; at sigma 1e-4 mean 0.96673,
        min 0.54336, 8 lanes at or below 0.95, 5 QP failures (code 2);
      - discrepancy fit at the JAX tests' rcond 1e-15, noiseless: mean
        0.98950, min 0.89758 (lane 201 of 256).
    So a fleet gate of "every lane above 0.95 and mean 0.99" fails on the
    reference itself at sigma 1e-4 and at rcond 1e-15 (about 10 s a case).
    """
    kind, n, (rounds, iters), rcond = WITNESS[case]
    sc = jpresets.not_state()
    dim_u = sc.model.A.shape[1] - 4
    if kind == "online":
        m0, fit = jd.online_from_bootstrap(sc.model.A, 4, 4, dim_u, alpha=1e2), jd.online_fit_iteration
    else:
        m0 = jd.discrep_bootstrap(sc.model.A, 4, 4, dim_u, capacity=12, rcond=rcond)
        fit = jd.discrep_fit_iteration
    qp = sc.config.qp_params.replace(n_rounds=rounds, max_iter=iters)
    sc = dataclasses.replace(sc, model=m0, config=dataclasses.replace(sc.config, streaming=True,
                                                                      qp_params=qp))
    plants, keys = jax_batch(jax.random.PRNGKey(1), sc.plant, n, detune_scale=0.01)
    a = np.asarray
    plants, keys = jax.tree.map(a, plants), a(keys)
    if kind == "online":
        plants = jax.tree.map(lambda v: np.concatenate([v, v]), plants)
        plants = plants.replace(sigma=plants.sigma + np.repeat([0.0, 1e-4], n))
        keys = np.concatenate([keys, keys])
    out_j = jax_host_loop(sc, (7, 1), model_update_fn=fit).run(
        sc.x0, jax.tree.map(a, m0), plants, a(sc.X_targ), a(sc.U_targ), a(sc.Q), a(sc.R),
        a(sc.Qf), keys, record=True)
    fid_j = np.real(a(out_j["final_x"]) @ np.conj(a(sc.target_state)))

    tsc, tplants = port_scenario(sc, plants, torch.float64, streaming=True)
    A = tsc.model.A
    if kind == "online":
        tm0, tfit = td.online_from_bootstrap(A, 4, 4, dim_u, alpha=1e2), td.online_fit_iteration
    else:
        tm0 = td.discrep_bootstrap(A, 4, 4, dim_u, capacity=12, rcond=rcond)
        tfit = td.discrep_fit_iteration
    noise = T(jax_noise(keys, sc.config.n_steps, 4)) if kind == "online" else None
    _, out = run_hostloop_fleet(dataclasses.replace(tsc, model=tm0), len(keys), plants=tplants,
                                noise=noise, model_update_fn=tfit)
    fid = fleet_fidelity(tsc, out["final_x"])
    np.testing.assert_array_equal(N(out["exit_code"]), a(out_j["exit_code"]))
    np.testing.assert_allclose(fid, fid_j, rtol=0, atol=1e-6)
    lost = lambda f: np.nonzero(f <= 0.95)[0].tolist()
    assert lost(fid) == lost(fid_j)
    if kind == "online":
        quiet, noisy = fid_j[:n], fid_j[n:]
        assert quiet.min() > 0.99 and (a(out_j["exit_code"])[:n] == 0).all()
        assert lost(noisy) and noisy.mean() < 0.99
    else:
        assert lost(fid_j) and fid_j.mean() < 0.99


# ---------------------------------------------------------------------------
# mpc(), exit codes and trim
# ---------------------------------------------------------------------------


def check_box_and_slew(us, sat, du, tol=1e-9):
    assert float(np.abs(us).max()) <= sat + tol
    assert float(np.abs(us[:, :2]).max()) <= du + tol           # anchored at U_targ = 0
    assert float(np.abs(np.diff(us[:, 1:], axis=1)).max()) <= du + tol


def assert_same_rollout(rt, rj):
    """A port mpc() result against a JAX one, lane-exact."""
    close(rt.xs, rj.xs, FLEET)
    close(rt.us, rj.us, FLEET)
    close(rt.objs, rj.objs, FLEET)
    np.testing.assert_array_equal(N(rt.sqp_iters), np.asarray(rj.sqp_iters))
    assert int(rt.n_valid) == int(rj.n_valid) and int(rt.exit_code) == int(rj.exit_code)


@pytest.fixture(scope="module")
def not_state_pair():
    sc = jpresets.not_state()
    tsc, _ = port_scenario(sc, jax.tree.map(lambda a: a[None], sc.plant), torch.float64)
    return sc, tsc


def test_mpc_streaming_matches_jax(not_state_pair):
    """The JAX package's streaming test (OnlineDMDc, alpha 1e2) through
    both `mpc()`s, observed at sigma 1e-5 with the same noise."""
    sc, tsc = not_state_pair
    m0 = jd.online_from_bootstrap(sc.model.A, 4, 4, sc.model.A.shape[1] - 4, alpha=1e2)
    cfg = dataclasses.replace(sc.config, streaming=True)
    plant = sc.plant.replace(sigma=jnp.asarray(SIGMA))
    key = jax.random.PRNGKey(1)
    rj = m4q.mpc(jnp.asarray(sc.x0), m0, plant, sc.X_targ, sc.U_targ, sc.Q, sc.R, sc.Qf, cfg,
                 sat=sc.sat, du=sc.du, key=key, model_update_fn=jd.online_fit_iteration)
    noise = jax_noise(key[None], cfg.n_steps, 4)[:, 0]
    A = tsc.model.A
    tplant = dataclasses.replace(tsc.plant, sigma=torch.tensor(SIGMA, dtype=torch.float64))
    tcfg = dataclasses.replace(tsc.config, streaming=True)
    boxqp_small.launches = 0
    m0t = td.online_from_bootstrap(A, 4, 4, A.shape[1] - 4, alpha=1e2)
    rt = tm.mpc(tsc.x0, m0t, tplant, tsc.X_targ, tsc.U_targ, tsc.Q, tsc.R, tsc.Qf, tcfg,
                tsc.sat, tsc.du, noise=T(noise), model_update_fn=td.online_fit_iteration)
    assert_same_rollout(rt, rj)
    assert int(rt.exit_code) == 0 and int(rt.n_valid) == 20
    assert float(rt.xs[3, -1].real) > 0.95
    close(rt.model_A, rj.model_A, FLEET)
    check_box_and_slew(N(rt.us), sc.sat, sc.du)
    assert rt.xs.shape == (4, 21) and float((rt.model_A - A).abs().max()) > 1e-10
    assert boxqp_small.launches == 0

    # the kernel route against the JAX host loop run as that route runs it
    runner = jax_host_loop(dataclasses.replace(sc, model=m0, config=cfg), (cfg.max_iter,),
                           model_update_fn=jd.online_fit_iteration)
    a = np.asarray
    plants = jax.tree.map(lambda v: a(v)[None], plant)
    oj = runner.run(sc.x0, jax.tree.map(a, m0), plants, a(sc.X_targ), a(sc.U_targ), a(sc.Q),
                    a(sc.R), a(sc.Qf), a(key)[None], record=True)
    rn = tm.mpc(tsc.x0, m0t, tplant, tsc.X_targ, tsc.U_targ, tsc.Q, tsc.R, tsc.Qf,
                dataclasses.replace(tcfg, qp_backend="ns"), tsc.sat, tsc.du, noise=T(noise),
                model_update_fn=td.online_fit_iteration)
    close(rn.xs, oj["xs"][0], FLEET)
    close(rn.us, oj["us"][0], FLEET)
    close(rn.objs, oj["objs"][0], FLEET)
    np.testing.assert_array_equal(N(rn.sqp_iters), oj["sqp_iters"][0])
    close(rn.model_A, oj["model_state"].A[0], FLEET)


def test_mpc_e_ops_observation_matches_jax(not_state_pair):
    """Observed through the Pauli e_ops at sigma 1e-4 (quantum_observe)."""
    sc, tsc = not_state_pair
    H0, H1s = np.asarray(sc.plant.H0), np.asarray(sc.plant.H1s)
    jplant = jq.QuantumPlant.create(H0, H1s, sigma=1e-4, e_ops=PAULIS)
    tplant = tq.QuantumPlant.create(H0, H1s, sigma=1e-4, e_ops=PAULIS, device="cpu")
    key = jax.random.PRNGKey(1)
    rj = m4q.mpc(jnp.asarray(sc.x0), sc.model, jplant, sc.X_targ, sc.U_targ, sc.Q, sc.R, sc.Qf,
                 sc.config, sat=sc.sat, du=sc.du, key=key, observe_fn=jq.quantum_observe)
    rt = tm.mpc(tsc.x0, tsc.model, tplant, tsc.X_targ, tsc.U_targ, tsc.Q, tsc.R, tsc.Qf,
                tsc.config, tsc.sat, tsc.du, observe_fn=tq.quantum_observe,
                noise=T(jax_noise(key[None], 20, 4)[:, 0]))
    assert_same_rollout(rt, rj)
    assert int(rt.exit_code) == 0 and float(rt.xs[3, -1].real) > 0.95
    check_box_and_slew(N(rt.us), sc.sat, sc.du)
    with pytest.raises(ValueError, match="sigma > 0"):
        tm.mpc(tsc.x0, tsc.model, tplant, tsc.X_targ, tsc.U_targ, tsc.Q, tsc.R, tsc.Qf,
               tsc.config, tsc.sat, tsc.du, observe_fn=tq.quantum_observe)


def test_mpc_exit_codes_and_trim_match_jax(not_state_pair):
    sc, tsc = not_state_pair
    args_j = (jnp.asarray(sc.x0), sc.model, sc.plant, sc.X_targ, sc.U_targ, sc.Q, sc.R, sc.Qf,
              sc.config)
    args_t = (tsc.x0, tsc.model, tsc.plant, tsc.X_targ, tsc.U_targ, tsc.Q, tsc.R, tsc.Qf,
              tsc.config, tsc.sat, tsc.du)
    key = jax.random.PRNGKey(1)
    # 1: the exit condition reads the current state
    rj = m4q.mpc(*args_j, sat=sc.sat, du=sc.du, key=key,
                 exit_condition=lambda xn, x, u: jnp.real(x[3]) > 0.9)
    rt = tm.mpc(*args_t, exit_condition=lambda xn, x, u: x[:, 3].real > 0.9)
    assert_same_rollout(rt, rj)
    assert int(rt.exit_code) == 1 and int(rt.n_valid) < 20
    for a, b in zip(tm.trim(rt), jax_trim(rj)):
        np.testing.assert_allclose(a, b, rtol=0, atol=FLEET)
    assert float(np.abs(N(rt.us)[:, int(rt.n_valid):]).max()) == 0.0
    # 0: every step
    r0 = tm.mpc(*args_t)
    assert_same_rollout(r0, m4q.mpc(*args_j, sat=sc.sat, du=sc.du, key=key))
    xs0, us0 = tm.trim(r0)
    assert int(r0.exit_code) == 0 and us0.shape == (1, 20) and xs0.shape == (4, 21)
    # 2: a NaN in the model fails the first QP: nothing applied
    bad = td.dmdc_from_operator(tsc.model.A.clone(), 4, 4, 8)
    bad.A[0, 0] = float("nan")
    r2 = tm.mpc(tsc.x0, bad, *args_t[2:])
    bad_j = sc.model.replace(A=sc.model.A.at[0, 0].set(jnp.nan))
    r2j = m4q.mpc(args_j[0], bad_j, *args_j[2:], sat=sc.sat, du=sc.du, key=key)
    assert int(r2.exit_code) == int(r2j.exit_code) and int(r2.exit_code) in (2, 3)
    assert int(r2.n_valid) == int(r2j.n_valid) == 0
    # the JAX contract of trim on the same numbers, codes 0-3
    for code, n in ((0, 20), (1, 7), (1, 0), (2, 5), (3, 0)):
        xs, us = np.arange(4 * 21.0).reshape(4, 21), np.arange(20.0).reshape(1, 20)
        res_t = tm.MPCResult(T(xs), T(us), torch.tensor(code), torch.tensor(n), None, None,
                             None, None)
        res_j = JaxResult(xs, us, np.asarray(code), np.asarray(n), None, None, None, None)
        for a, b in zip(tm.trim(res_t), jax_trim(res_j)):
            np.testing.assert_array_equal(a, b)

