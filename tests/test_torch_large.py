"""The port's two largest paths against the JAX package on the CPU (x64
there, float64 in the port unless a test says float32), on numpy inputs
made from a seed:

- The damped four-qubit chain (the JAX tests' three-qubit problem,
  tests/test_tensor_parallel.py `make_3q_scenario`, extended to four qubits
  with amplitude damping on each: a 256 x 256 Liouvillian plant step, QP
  n 32) and cnot_state at horizon 250 (QP n 750), each built by
  chip_smoke.py from the port's public constructors and held, array for
  array, to the same scenario built here in the JAX package; each run as a
  plain Scenario outside the tuning tables (8 warm SQP iterations, cold
  duals, the scenario's own budget) by the port in float64 and by JAX's
  `run_hostloop_fleet(cpu=True)` on the same JAX-drawn plants, at B 2: the
  chain over all its 6 steps, cnot_h250 over its first step only (its 24
  cold Newton-Schulz K^-1 builds at n 750 take 30-50 s a side on one
  thread).
- The chain's float32 closed loop against float64, in the JAX package and
  in the port: the witness for the bounds its card run is held to.
- `expm_small`'s plain version at d 117 and 256 (the sizes of the
  cluster2d instance on the card) against JAX's `ops/expm.expm_taylor` and
  `scipy.linalg.expm`.
- `admm_big`'s plain version at n 750 (cnot_h250's QP) against the Pallas
  `_admm_iters_lanes(interpret=True)` (about 8 s at n 750 in interpret mode
  on a CPU).

Tolerances: scenario arrays 1e-12; expm 1e-12 in float64 (against scipy at
the any-norm budget (18, 12), against JAX at the same budget as the port),
1e-5 in float32; ADMM 1e-5 relative to max(1, |ref|), float32 on both sides
(the row sums run in different orders); fleets FLEET_TOL = 1e-8 on the
final states, exit codes and the budget metrics equal.
"""

import dataclasses

import numpy as np
import pytest
import scipy.linalg
import torch
import jax
import jax.numpy as jnp

from mpc4quantum_tpu import benchfleet as jbench
from mpc4quantum_tpu import presets as jpresets
from mpc4quantum_tpu.models.dmdc import dmdc_from_operator as jax_dmdc
from mpc4quantum_tpu.mpc.driver import MPCConfig as JaxMPCConfig
from mpc4quantum_tpu.ops import liouville as jliou
from mpc4quantum_tpu.ops.expm import expm_taylor as jax_expm_taylor
from mpc4quantum_tpu.ops.pallas_qp import _admm_iters_lanes
from mpc4quantum_tpu.parallel.fleet import make_scenario_batch as jax_batch
from mpc4quantum_tpu.plants import lindblad as jlind
from mpc4quantum_tpu.solvers.boxqp import ns_inverse as jax_ns_inverse

import chip_smoke
from mpc4quantum_tpu_torch.benchfleet import run_hostloop_fleet
from mpc4quantum_tpu_torch.convert import plant_from_numpy
from mpc4quantum_tpu_torch.kernels.admm_big import admm_iters_ref
from mpc4quantum_tpu_torch.kernels.expm import expm_small, expm_small_ref
from mpc4quantum_tpu_torch.solvers.boxqp import ns_inverse

EXACT = 1e-12
F32 = 1e-5
FLEET_TOL = 1e-8
B = 2
CONFIG_FIELDS = ("horizon", "n_steps", "dt", "dim_u", "order", "measure_freq", "warm_start",
                 "step_tol")
QP_FIELDS = ("rho0", "sigma", "alpha", "eps_abs", "eps_rel", "max_iter", "n_rounds",
             "accept_abs", "accept_rel", "ns_iters", "kinv", "scale")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One thread per test process: a pool for each of several test
    processes slows them all down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(t, j, tol=EXACT):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=0, atol=tol)


def crandn(rng, *shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


# ------------------------------------------------------------ the scenarios

def kron4(ops: dict) -> np.ndarray:
    """The four-qubit operator with ops[k] on qubit k, the identity elsewhere."""
    eye = np.eye(2, dtype=complex)
    return np.kron(np.kron(ops.get(0, eye), ops.get(1, eye)),
                   np.kron(ops.get(2, eye), ops.get(3, eye)))


def jax_damped_chain4(gamma: float = 0.005, coupling: float = 0.1):
    """The damped chain in the JAX package: make_3q_scenario's couplings,
    drives, start and costs on four qubits, with sqrt(gamma) sigma_- on
    each in the order-1 model and in a LindbladPlant."""
    X = np.array([[0, 1], [1, 0]], complex)
    Z = np.array([[1, 0], [0, -1]], complex)
    sminus = np.sqrt(gamma) * np.array([[0.0, 1.0], [0.0, 0.0]], complex)
    H0 = 0.5 * coupling * (kron4({0: Z, 1: Z}) + kron4({1: Z, 2: Z}) + kron4({2: Z, 3: Z}))
    H1s = [0.5 * kron4({k: X}) for k in range(4)]
    c_ops = [kron4({k: sminus}) for k in range(4)]
    dt, H, n_steps, order = 0.5, 8, 6, 1
    A_cts = ([np.asarray(jliou.lindblad_generator(H0, c_ops))]
             + [np.asarray(jliou.liouville_generator(h)) for h in H1s])
    A = np.asarray(jliou.discretize_homogeneous(A_cts, dt, order))
    th = 1e-2
    R1 = np.array([[np.cos(th / 2), -1j * np.sin(th / 2)], [-1j * np.sin(th / 2), np.cos(th / 2)]])
    R = kron4({k: R1 for k in range(4)})
    rho0 = np.zeros((16, 16), complex)
    rho0[0, 0] = 1.0
    rho0 = R @ rho0 @ R.conj().T
    targ = np.zeros((16, 16), complex)
    targ[15, 15] = 1.0
    Qd = np.zeros(256)
    Qd[0] = Qd[255] = 1.0
    Q = jnp.asarray(np.diag(Qd).astype(complex))
    return jpresets.Scenario(
        name="damped_chain4", x0=rho0.flatten(),
        model=jax_dmdc(jnp.asarray(A), 256, 256, A.shape[1] - 256),
        plant=jlind.LindbladPlant.create(H0, H1s, c_ops=c_ops),
        X_targ=jnp.asarray(np.tile(targ.flatten()[:, None], (1, n_steps + H + 1))),
        U_targ=jnp.zeros((4, n_steps + H)), Q=Q, R=jnp.eye(4) * 1e-2, Qf=Q,
        config=JaxMPCConfig(horizon=H, n_steps=n_steps, dt=dt, dim_u=4, order=order),
        sat=2.5, du=None, target_state=targ.flatten(), plant_step_fn=jlind.lindblad_step,
        lift_fn=jlind.lindblad_lift, proj_fn=jlind.lindblad_proj)


def jax_cnot_h250(horizon: int = 250):
    """cnot_state at order 2 and horizon 250 in the JAX package, its targets
    rebuilt for the longer window with the same incline."""
    sc = jpresets.cnot_state(order=2)
    n = sc.config.n_steps
    incline = np.array([min(1.0, 2 * k / n) for k in range(n + horizon + 1)])
    return dataclasses.replace(
        sc, name="cnot_h250", X_targ=jnp.asarray(np.asarray(sc.target_state)[:, None] * incline),
        U_targ=jnp.zeros((3, n + horizon)),
        config=dataclasses.replace(sc.config, horizon=horizon))


# name: (JAX constructor, port constructor, QP n, plant expm budget, steps run)
LARGE = {"damped_chain4": (jax_damped_chain4, chip_smoke.damped_chain4_scenario, 32, (12, 4), 6),
         "cnot_h250": (jax_cnot_h250, chip_smoke.cnot_h250_scenario, 750, (12, 0), 1)}


def cut(sc, steps):
    return dataclasses.replace(sc, config=dataclasses.replace(sc.config, n_steps=steps))


def fast_qp(sc):
    """The scan form of the JAX ADMM loop for CPU traces."""
    return dataclasses.replace(sc, config=dataclasses.replace(
        sc.config, qp_params=sc.config.qp_params.replace(unroll=False)))


def plant_fields(p) -> dict:
    names = ("AH0", "AD", "A1s", "sigma") if hasattr(p, "AD") else ("H0", "H1s", "sigma")
    return {k: np.asarray(getattr(p, k)) for k in names}


@pytest.mark.parametrize("name", sorted(LARGE))
def test_large_scenario_is_the_jax_one(name):
    """chip_smoke.py builds the scenario from the port's constructors; it
    is the JAX package's, array for array."""
    make_j, make_t, n_qp, _, _ = LARGE[name]
    sc_j, sc = make_j(), make_t("cpu", torch.float64)
    assert sc.name == sc_j.name == name
    for f in ("x0", "X_targ", "U_targ", "Q", "R", "Qf", "target_state"):
        close(getattr(sc, f), getattr(sc_j, f))
    close(sc.model.A, sc_j.model.A)
    for f in CONFIG_FIELDS:
        assert getattr(sc.config, f) == getattr(sc_j.config, f), f
    for f in QP_FIELDS:
        assert getattr(sc.config.qp_params, f) == getattr(sc_j.config.qp_params, f), f
    assert (sc.sat, sc.du) == (sc_j.sat, sc_j.du)
    assert sc.config.horizon * sc.config.dim_u == n_qp
    ours = {k: v.numpy() for k, v in sc.plant.tensor_fields().items()}
    theirs = plant_fields(sc_j.plant)
    assert set(ours) == set(theirs)
    for k in ours:
        close(ours[k], theirs[k])


@pytest.fixture(scope="module", params=sorted(LARGE))
def reference(request):
    """One JAX run per scenario at B 2 over its steps."""
    make_j, _, _, _, steps = LARGE[request.param]
    sc = fast_qp(cut(make_j(), steps))
    plants, keys = jax_batch(jax.random.PRNGKey(1), sc.plant, B, detune_scale=0.01)
    metrics, out = jbench.run_hostloop_fleet(sc, B, cpu=True, _plants=plants, _keys=keys)
    return request.param, plants, metrics, out


def test_large_fleet_float64_matches_jax(reference):
    name, plants_j, m_j, out_j = reference
    _, make_t, n_qp, budget, steps = LARGE[name]
    sc = cut(make_t("cpu", torch.float64), steps)
    plants = plant_from_numpy(plant_fields(plants_j))
    m, out = run_hostloop_fleet(sc, B, plants=plants)
    close(out["final_x"], out_j["final_x"], FLEET_TOL)
    np.testing.assert_array_equal(out["exit_code"].numpy(), out_j["exit_code"])
    for key in ("warm_sqp_iters", "warm_budget", "steady_budget", "warm_duals", "completed_frac",
                "qp_fail_frac", "fidelity_min", "fidelity_mean", "lqr_seed", "qp_scale"):
        assert m[key] == m_j[key], key
    assert m["warm_sqp_iters"] == 8 and not m["warm_duals"]
    assert m["completed_frac"] == 1.0 and m["qp_fail_frac"] == 0.0
    assert m["qp_kernel"] == "big" and tuple(m["expm_budget"]) == budget
    qp = sc.config.qp_params
    assert m["warm_budget"] == m["steady_budget"] == f"{qp.n_rounds}x{qp.max_iter}"


def fidelity(sc, final_x) -> np.ndarray:
    targ = np.asarray(sc.target_state).astype(np.complex128)
    x = np.asarray(final_x).astype(np.complex128)
    return np.real(x @ np.conj(targ)) / np.real(targ @ np.conj(targ))


def test_chain_float32_branches_in_jax_too():
    """The witness for the card's bounds on damped_chain4 (chip_smoke.py
    SLICE_FLEETS): in float32 the chain's closed loop leaves float64 in
    step 1's eight line-searched SQP iterations, in the JAX package as in
    the port. On 2 JAX-drawn lanes over all 6 steps the JAX package's own
    float32 run ends more than 5e-2 from float64 and the port's float32
    run more than 1e-3 (within 5e-2), and after the first step the port's
    float32 run is within 1e-5 of float64."""
    with jax.enable_x64(False):
        sc_j = fast_qp(jax_damped_chain4())
        plants_j, keys = jax_batch(jax.random.PRNGKey(1), sc_j.plant, B, detune_scale=0.01)
        _, out_j = jbench.run_hostloop_fleet(sc_j, B, cpu=True, _plants=plants_j, _keys=keys)
        assert np.asarray(out_j["final_x"]).dtype == np.complex64
        fid_j32 = fidelity(sc_j, out_j["final_x"])
        fields = {k: np.asarray(v, np.complex128 if np.iscomplexobj(v) else np.float64)
                  for k, v in plant_fields(plants_j).items()}
    plants64 = plant_from_numpy(fields)
    fid = {}
    for steps in (1, 6):
        for dtype in (torch.float32, torch.float64):
            sc = cut(chip_smoke.damped_chain4_scenario("cpu", dtype), steps)
            _, out = run_hostloop_fleet(sc, B, plants=plants64.to("cpu", dtype))
            fid[steps, dtype] = fidelity(sc, out["final_x"].numpy())
    port_gap = np.abs(fid[6, torch.float32] - fid[6, torch.float64]).max()
    assert np.abs(fid_j32 - fid[6, torch.float64]).max() > 5e-2
    assert 1e-3 < port_gap < 5e-2
    assert np.abs(fid[1, torch.float32] - fid[1, torch.float64]).max() < 1e-5


def test_ns_inverse_float32_last_step_in_float64():
    """cnot_h250's fix: in float32 the Newton-Schulz iteration stalls where
    the rounding of K X is as large as the residual, and the port takes its
    last step with I - K X formed in float64. On an SPD K (n 200, cond 1e3)
    that brings ||I - K X||_inf within 2x of float64's inverse rounded to
    float32, and at least 4x below float32's own iteration; in float64
    every step stays X (2I - K X), as the JAX package's ns_inverse takes it."""
    n, iters = 200, 30
    rng = np.random.default_rng(n)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    K = (Q * np.exp(rng.uniform(0.0, np.log(1e3), n))) @ Q.T
    K = 0.5 * (K + K.T)

    def plain(K, iters):
        eye = torch.eye(n, dtype=K.dtype)
        X = K.mT / (K.abs().sum(-2).amax(-1) * K.abs().sum(-1).amax(-1))[..., None, None]
        for _ in range(iters):
            X = X @ (2.0 * eye - K @ X)
        return X

    def residual(X):
        return float(np.abs(np.eye(n) - K @ X[0].double().numpy()).sum(1).max())

    K32 = torch.tensor(K[None], dtype=torch.float32)
    mixed, f32 = residual(ns_inverse(K32, iters)), residual(plain(K32, iters))
    floor = residual(ns_inverse(torch.tensor(K[None]), iters).float())
    assert mixed < 2 * floor and 4 * mixed < f32
    K64 = torch.tensor(K[None])
    assert torch.equal(ns_inverse(K64, iters), plain(K64, iters))
    close(ns_inverse(K64, iters), jax_ns_inverse(jnp.asarray(K[None]), iters=iters))


# ------------------------------------------------------------------ expm_small

def generators(kind: str, B: int, d: int, seed: int, lo: float, hi: float) -> np.ndarray:
    """B matrices (d, d) with 1-norms log-uniform in [lo, hi]: -i H for a
    Hermitian H ("hermitian"), the Lindbladian -i[H, .] + D[L] of a
    sqrt(d)-level system ("liouvillian", non-normal), or a complex Gaussian
    matrix ("nonnormal")."""
    rng = np.random.default_rng(seed)
    if kind == "hermitian":
        G = crandn(rng, B, d, d)
        A = -0.5j * (G + np.conj(np.swapaxes(G, 1, 2)))
    elif kind == "liouvillian":
        D = int(round(np.sqrt(d)))
        A = np.stack([np.asarray(jliou.lindblad_generator(
            0.5 * (G + G.conj().T), [0.3 * crandn(rng, D, D)]))
            for G in crandn(rng, B, D, D)])
    else:
        A = crandn(rng, B, d, d)
    norms = np.exp(rng.uniform(np.log(lo), np.log(hi), size=B))
    return A * (norms / np.abs(A).sum(axis=1).max(axis=1))[:, None, None]


@pytest.mark.parametrize("d,kind,budget", [(117, "hermitian", (12, 2)), (117, "nonnormal", (12, 2)),
                                           (256, "hermitian", (12, 2)),
                                           (256, "liouvillian", (12, 4))])
def test_expm_ref_at_the_cluster2d_sizes_matches_jax_and_scipy(d, kind, budget):
    """At d 117 and 256 across the squaring branches (norms 0.3 to 2^(s-1)
    + 1 at max_squarings s): against JAX at the same budget in float64 and
    float32, and at the any-norm budget against scipy in float64; (12, 4)
    is damped_chain4's plant step on Liouvillians of a 16-level system."""
    k, sq = budget
    A = generators(kind, 4, d, seed=d + sq, lo=0.3, hi=2.0 ** (sq - 1) + 1.0)
    norms = np.abs(A).sum(axis=1).max(axis=1)
    assert (norms < 1).any() and (norms > 1).any()
    ours = expm_small_ref(torch.tensor(A), taylor_k=k, max_squarings=sq)
    close(ours, jax_expm_taylor(jnp.asarray(A), order=k, max_squarings=sq))
    ours32 = expm_small(torch.tensor(A, dtype=torch.complex64), taylor_k=k, max_squarings=sq)
    assert ours32.dtype == torch.complex64
    close(ours32, jax_expm_taylor(jnp.asarray(A, jnp.complex64), order=k, max_squarings=sq), F32)
    exact = np.stack([scipy.linalg.expm(a) for a in A])
    close(expm_small_ref(torch.tensor(A), taylor_k=18, max_squarings=12), exact)
    close(ours32, exact, F32)


# -------------------------------------------------------------------- admm_big

def test_admm_iters_ref_matches_pallas_interpret_at_n750():
    """cnot_h250's QP size: B 8 lanes padded to 128 as boxqp_pallas_big
    pads them (identity inverse, q = 0, box [-1, 1], zero iterates), 15
    iterations."""
    n, Bl, Bp, iters, sigma, alpha = 750, 8, 128, 15, 1e-6, 1.6
    rng = np.random.default_rng(n)
    G = rng.normal(size=(Bl, n, n))
    P = G @ np.swapaxes(G, 1, 2) / n + 0.5 * np.eye(n)
    q = rng.normal(size=(Bl, n)) * 2
    lb, ub = -np.abs(rng.normal(size=(Bl, n))), np.abs(rng.normal(size=(Bl, n)))
    rho = rng.uniform(0.05, 2.0, Bl)
    kinv = np.linalg.inv(P + (sigma + rho)[:, None, None] * np.eye(n))
    x, z, y = (rng.normal(size=(Bl, n)) * s for s in (0.3, 0.3, 0.5))
    f32 = lambda a: np.asarray(a, np.float32)
    pad = lambda a, fill: np.concatenate([a, np.full((Bp - Bl,) + a.shape[1:], fill)])
    kinv_p = np.concatenate([kinv, np.broadcast_to(np.eye(n), (Bp - Bl, n, n))])
    lanes = lambda a, fill: jnp.asarray(f32(pad(a, fill)).T)
    ref = _admm_iters_lanes(jnp.asarray(f32(kinv_p)), lanes(q, 0.0), lanes(lb, -1.0),
                            lanes(ub, 1.0), jnp.asarray(f32(pad(rho, 0.1))[None, :]),
                            lanes(x, 0.0), lanes(z, 0.0), lanes(y, 0.0), iters=iters,
                            sigma=sigma, alpha=alpha, interpret=True)
    t = lambda a: torch.tensor(f32(a))
    ours = admm_iters_ref(t(kinv), t(q), t(lb), t(ub), t(rho), t(x), t(z), t(y),
                          iters=iters, sigma=sigma, alpha=alpha)
    for o, r in zip(ours, ref):
        r = np.asarray(r)[:, :Bl].T
        close(o, r, F32 * max(1.0, np.abs(r).max()))
    # not vacuous: the box binds and the iterates moved
    assert bool(((ours[1] == t(lb)) | (ours[1] == t(ub))).any())
    assert float((ours[0] - t(x)).abs().max()) > 1e-2
