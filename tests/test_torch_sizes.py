"""The sizes the JAX package runs and the port's kernels now take too, against
the JAX package on the CPU (x64 there, float64 in the port unless a test
says float32), on numpy inputs made from a seed:

- `expm_small`'s plain version at d 9, 16 and 33 (the tile and cluster
  instances' sizes on the card) against JAX's `ops/expm.expm_taylor` (the XLA form
  the JAX plant steps run) and against `scipy.linalg.expm` in float64, on
  Hermitian generators, Liouvillians of a damped system and a non-normal
  matrix, across the 0- and 1-squaring branches; and a real float32 batch
  against `expm_pallas(interpret=True)` on the same real input. The Pallas
  kernel itself is not run at d 9: its trace unrolls d^3 products a step,
  and in interpret mode on a CPU it did not compile within 15 minutes (d 4
  takes about 10 s).
- `admm_big`'s plain version at n 240 and 256 (the cluster instance's
  sizes) against the Pallas `_admm_iters_lanes(interpret=True)`.
- The wrappers' argument checks, a function of shapes: every n and d is
  taken, bad dtypes and shapes are refused.
- The slice's fleets, each a plain Scenario outside the tuning tables, run
  as JAX's `run_hostloop_fleet(cpu=True)` runs any Scenario (8 warm SQP
  iterations, cold duals, the scenario's own 3x300): the damped CNOT pair
  (a 16 x 16 Liouvillian plant step, QP n 150) and cnot_state at horizon
  80 (QP n 240), each built by presets.py from the port's public
  constructors and held to the same scenario built in the JAX package.

Tolerances: scenario arrays 1e-12; expm 1e-12 in float64 (against scipy
at the any-norm budget (18, 12), whose truncation is below 1e-16; against
JAX at the same budget as the port), 1e-5 in float32; ADMM 1e-5 relative
to max(1, |ref|), float32 on both sides (the row sums run in different
orders); fleets FLEET_TOL = 1e-8 on the final states, exit codes and the
budget metrics equal.
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
from mpc4quantum_tpu import systems as jsystems
from mpc4quantum_tpu.models.dmdc import dmdc_from_operator as jax_dmdc
from mpc4quantum_tpu.ops import liouville as jliou
from mpc4quantum_tpu.ops.expm import expm_taylor as jax_expm_taylor
from mpc4quantum_tpu.ops.pallas_expm import expm_pallas
from mpc4quantum_tpu.ops.pallas_qp import _admm_iters_lanes
from mpc4quantum_tpu.parallel.fleet import make_scenario_batch as jax_batch
from mpc4quantum_tpu.plants import lindblad as jlind

from mpc4quantum_tpu_torch import presets
from mpc4quantum_tpu_torch.benchfleet import run_hostloop_fleet
from mpc4quantum_tpu_torch.convert import plant_from_numpy
from mpc4quantum_tpu_torch.kernels.admm_big import admm_iters_ref, check_admm_args
from mpc4quantum_tpu_torch.kernels.expm import check_expm_args, expm_small, expm_small_ref

EXACT = 1e-12
F32 = 1e-5
FLEET_TOL = 1e-8
B = 2
STEPS = 4
CONFIG_FIELDS = ("horizon", "n_steps", "dt", "dim_u", "order", "measure_freq", "warm_start",
                 "step_tol")
QP_FIELDS = ("rho0", "sigma", "alpha", "eps_abs", "eps_rel", "max_iter", "n_rounds",
             "accept_abs", "accept_rel", "ns_iters", "kinv", "scale")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small matrices on a few lanes: one thread runs them as fast as many,
    and a pool for each of several test processes slows them down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(t, j, tol=EXACT):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=0, atol=tol)


def crandn(rng, *shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


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


# ------------------------------------------------------------------ expm_small

EXPM_CASES = [(9, "hermitian"), (9, "liouvillian"), (16, "hermitian"), (16, "liouvillian"),
              (33, "hermitian"), (33, "nonnormal")]


@pytest.mark.parametrize("d,kind", EXPM_CASES)
def test_expm_ref_matches_jax_and_scipy(d, kind):
    """Across the 0- and 1-squaring branches (norms 0.3-1.6 at
    max_squarings 1) against JAX at the same budget, float64 and float32,
    and at the any-norm budget against scipy in float64."""
    A = generators(kind, 6, d, seed=d, lo=0.3, hi=1.6)
    norms = np.abs(A).sum(axis=1).max(axis=1)
    assert (norms < 1).any() and (norms > 1).any()
    ours = expm_small_ref(torch.tensor(A), taylor_k=12, max_squarings=1)
    close(ours, jax_expm_taylor(jnp.asarray(A), order=12, max_squarings=1))
    ours32 = expm_small(torch.tensor(A, dtype=torch.complex64), taylor_k=12, max_squarings=1)
    assert ours32.dtype == torch.complex64
    close(ours32, jax_expm_taylor(jnp.asarray(A, jnp.complex64), order=12, max_squarings=1), F32)
    exact = np.stack([scipy.linalg.expm(a) for a in A])
    close(expm_small_ref(torch.tensor(A), taylor_k=18, max_squarings=12), exact)
    close(ours32, exact, F32)
    # the certified form (no norm, no squaring) on norms below 1
    small = A * (0.8 / norms)[:, None, None]
    close(expm_small_ref(torch.tensor(small), taylor_k=12, max_squarings=0),
          jax_expm_taylor(jnp.asarray(small), order=12, fixed_squarings=0))


def test_expm_real_input_matches_pallas():
    """A real float32 batch, as `expm_pallas` takes it: real in, real out,
    against the Pallas kernel in interpret mode on the same input."""
    rng = np.random.default_rng(4)
    A = (rng.normal(size=(8, 2, 2)) * 0.8).astype(np.float32)
    ours = expm_small(torch.tensor(A), taylor_k=12, max_squarings=2)
    ref = expm_pallas(jnp.asarray(A), max_squarings=2, interpret=True, sublanes=1, taylor_k=12)
    assert ours.dtype == torch.float32 and ref.dtype == jnp.float32
    close(ours, ref, F32)
    close(ours, np.stack([scipy.linalg.expm(a.astype(float)) for a in A]), F32)


# -------------------------------------------------------------------- admm_big

@pytest.mark.parametrize("n", [240, 256])
def test_admm_iters_ref_matches_pallas_interpret_above_239(n):
    """The cluster instance's sizes: B 8 lanes padded to 128 as
    boxqp_pallas_big pads them (identity inverse, q = 0, box [-1, 1], zero
    iterates), 15 iterations."""
    Bl, Bp, iters, sigma, alpha = 8, 128, 15, 1e-6, 1.6
    rng = np.random.default_rng(n)
    G = rng.normal(size=(Bl, n, n))
    P = np.einsum("bij,bkj->bik", G, G) / n + 0.5 * np.eye(n)
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


# ------------------------------------------------------------ argument checks

@pytest.mark.parametrize("d", [1, 9, 16, 100])
def test_expm_check_takes_every_d(d):
    for dtype in (torch.complex64, torch.float32):
        assert check_expm_args((5, d, d), dtype, 12, 0) == (5, d)
        assert check_expm_args((5, d, d), dtype, 18, 12) == (5, d)


@pytest.mark.parametrize("n", [240, 1024])
def test_admm_check_takes_every_n(n):
    B = 3
    specs = {k: ((B, n), torch.float32, True) for k in ("q", "lb", "ub", "x", "z", "y")}
    specs.update(kinv=((B, n, n), torch.float32, True), rho=((B,), torch.float32, True))
    assert check_admm_args(specs, iters=80) == (B, n)


def test_checks_refuse_bad_dtypes_and_shapes():
    for shape, dtype in (((4, 9, 9), torch.complex128), ((4, 9, 9), torch.float64),
                         ((4, 9, 8), torch.complex64), ((9, 9), torch.complex64),
                         ((4, 0, 0), torch.complex64)):
        with pytest.raises(ValueError, match="expm_small"):
            check_expm_args(shape, dtype, 12, 0)
    for k, sq in ((0, 0), (12, -1)):
        with pytest.raises(ValueError, match="taylor_k"):
            check_expm_args((4, 9, 9), torch.complex64, k, sq)
    B, n = 3, 300
    good = {k: ((B, n), torch.float32, True) for k in ("q", "lb", "ub", "x", "z", "y")}
    good.update(kinv=((B, n, n), torch.float32, True), rho=((B,), torch.float32, True))
    bad = [("kinv", ((B, n, n + 1), torch.float32, True)),
           ("kinv", ((B, n, n), torch.float64, True)),
           ("kinv", ((B, n, n), torch.float32, False)), ("q", ((B, n + 1), torch.float32, True)),
           ("rho", ((B, n), torch.float32, True)), ("y", ((B, n), torch.float16, True)),
           ("kinv", ((B, 0, 0), torch.float32, True))]
    for name, spec in bad:
        with pytest.raises(ValueError, match="admm_big"):
            check_admm_args({**good, name: spec}, iters=1)
    with pytest.raises(ValueError, match="iters"):
        check_admm_args(good, iters=-1)


# ------------------------------------------------------------ the slice's fleets

def jax_damped_pair(gamma: float = 0.005):
    """The damped pair in the JAX package: cnot_state's pair with
    sqrt(gamma) sigma_- on each qubit, built as presets.lindblad_state
    builds its qubit."""
    sc = jpresets.cnot_state(order=2)
    H_list = jsystems.RWACoupled().H_list
    sminus = np.sqrt(gamma) * np.array([[0.0, 1.0], [0.0, 0.0]], complex)
    c_ops = [np.kron(sminus, np.eye(2)), np.kron(np.eye(2), sminus)]
    A_cts = ([np.asarray(jliou.lindblad_generator(H_list[0], c_ops))]
             + [np.asarray(jliou.liouville_generator(h)) for h in H_list[1:]])
    A = np.asarray(jliou.discretize_homogeneous(A_cts, sc.config.dt, 2))
    return dataclasses.replace(
        sc, name="damped_pair", model=jax_dmdc(jnp.asarray(A), 16, 16, A.shape[1] - 16),
        plant=jlind.LindbladPlant.create(H_list[0], H_list[1:], c_ops=c_ops),
        plant_step_fn=jlind.lindblad_step, lift_fn=jlind.lindblad_lift,
        proj_fn=jlind.lindblad_proj)


def jax_cnot_h80(horizon: int = 80):
    """cnot_state at order 2 and horizon 80 in the JAX package, its targets
    rebuilt for the longer window with the same incline."""
    sc = jpresets.cnot_state(order=2)
    n = sc.config.n_steps
    incline = np.array([min(1.0, 2 * k / n) for k in range(n + horizon + 1)])
    return dataclasses.replace(
        sc, name="cnot_h80", X_targ=jnp.asarray(np.asarray(sc.target_state)[:, None] * incline),
        U_targ=jnp.zeros((3, n + horizon)),
        config=dataclasses.replace(sc.config, horizon=horizon))


SLICE = {"damped_pair": (jax_damped_pair, presets.damped_pair_scenario, 150, (12, 1)),
         "cnot_h80": (jax_cnot_h80, presets.cnot_h80_scenario, 240, (12, 0))}


def cut(sc, steps):
    return dataclasses.replace(sc, config=dataclasses.replace(sc.config, n_steps=steps))


def fast_qp(sc):
    """The scan form of the JAX ADMM loop for CPU traces."""
    return dataclasses.replace(sc, config=dataclasses.replace(
        sc.config, qp_params=sc.config.qp_params.replace(unroll=False)))


def plant_fields(p) -> dict:
    names = ("AH0", "AD", "A1s", "sigma") if hasattr(p, "AD") else ("H0", "H1s", "sigma")
    return {k: np.asarray(getattr(p, k)) for k in names}


@pytest.mark.parametrize("name", sorted(SLICE))
def test_slice_scenario_is_the_jax_one(name):
    """presets.py builds the scenario from the port's constructors; it
    is the JAX package's, array for array."""
    make_j, make_t, n_qp, _ = SLICE[name]
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


@pytest.fixture(scope="module", params=sorted(SLICE))
def reference(request):
    """One JAX run per scenario, B 2, 4 steps (about 10-15 s each)."""
    make_j = SLICE[request.param][0]
    sc = fast_qp(cut(make_j(), STEPS))
    plants, keys = jax_batch(jax.random.PRNGKey(1), sc.plant, B, detune_scale=0.01)
    metrics, out = jbench.run_hostloop_fleet(sc, B, cpu=True, _plants=plants, _keys=keys)
    return request.param, plants, metrics, out


def test_slice_fleet_float64_matches_jax(reference):
    name, plants_j, m_j, out_j = reference
    _, make_t, n_qp, budget = SLICE[name]
    sc = cut(make_t("cpu", torch.float64), STEPS)
    plants = plant_from_numpy(plant_fields(plants_j))
    m, out = run_hostloop_fleet(sc, B, plants=plants)
    close(out["final_x"], out_j["final_x"], FLEET_TOL)
    np.testing.assert_array_equal(out["exit_code"].numpy(), out_j["exit_code"])
    for key in ("warm_sqp_iters", "warm_budget", "steady_budget", "warm_duals", "completed_frac",
                "qp_fail_frac", "fidelity_min", "fidelity_mean", "lqr_seed", "qp_scale"):
        assert m[key] == m_j[key], key
    assert (m["warm_sqp_iters"], m["warm_budget"], m["steady_budget"]) == (8, "3x300", "3x300")
    assert not m["warm_duals"] and m["completed_frac"] == 1.0 and m["qp_fail_frac"] == 0.0
    assert m["qp_kernel"] == "big" and tuple(m["expm_budget"]) == budget
