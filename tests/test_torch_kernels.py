"""The port's kernel modules against the JAX package, on the CPU.

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py
and chip_smoke.py hold them against these plain versions there). Here:
  - boxqp_small_ref, unscaled and Jacobi-scaled, against the vmapped JAX
    solve_boxqp_fixed with the Gauss-Jordan K-inverse (kinv="gj"), the
    documented iterate-for-iterate mirror of the Pallas QP kernel, in float64
    at tolerance 1e-10; the scaled form also against the Pallas kernel in
    interpret mode, in float32;
  - admm_iters_ref against the large-n Pallas ADMM kernel in interpret mode,
    in float32;
  - boxqp_big (with each K-inverse: Gauss-Jordan, Newton-Schulz cold and
    from a carried inverse, Riccati), ns_inverse (cold and warm-started) and
    jacobi_scale_boxqp against their JAX counterparts in float64;
  - expm_small_ref against the Pallas expm kernel run in interpret mode, in
    complex128 at tolerance 1e-10, in every form the fleets run (d = 2 at
    (12, 0) and (18, 12), d = 3 at (12, 2), d = 4 on Liouvillians at
    (12, 1)), and its norm guard at max_squarings = 0;
  - the wrappers take the plain version on CPU tensors and count no launch.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mpc4quantum_tpu.ops.pallas_expm import expm_pallas
from mpc4quantum_tpu.ops.pallas_qp import _admm_iters_lanes, boxqp_pallas
from mpc4quantum_tpu.solvers.boxqp import BoxQPParams as JBoxQPParams, solve_boxqp_fixed
from mpc4quantum_tpu.solvers.boxqp import jacobi_scale_boxqp as jax_jacobi_scale
from mpc4quantum_tpu.solvers.boxqp import ns_inverse as jax_ns_inverse

from mpc4quantum_tpu_torch.kernels import _build
from mpc4quantum_tpu_torch.kernels.admm_big import admm_big, admm_iters_ref
from mpc4quantum_tpu_torch.kernels.boxqp import (boxqp_accept, boxqp_big, boxqp_small,
                                                 boxqp_small_ref)
from mpc4quantum_tpu_torch.kernels.expm import expm_small, expm_small_ref
from mpc4quantum_tpu_torch.solvers.boxqp import jacobi_scale_boxqp, ns_inverse

TOL = 1e-10


def make_batch(B, n, seed):
    """SPD box QPs, as tests/test_pallas_qp.py builds them (in float64)."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(B, n, n))
    P = np.einsum("bij,bkj->bik", G, G) + 0.5 * np.eye(n)
    q = rng.normal(size=(B, n)) * 2
    lb = -np.abs(rng.normal(size=(B, n)))
    ub = np.abs(rng.normal(size=(B, n)))
    return P, q, lb, ub


def spread_batch(B, n, seed, spread=1.0):
    """SPD box QPs whose diagonal spans orders of magnitude (exp(N(0,
    spread^2)) row weights), where Jacobi scaling changes the iterates."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(B, n, n))
    P = np.einsum("bij,bkj->bik", G, G) / n + 0.5 * np.eye(n)
    d = np.exp(rng.normal(scale=spread, size=(B, n)))
    P = P * d[:, :, None] * d[:, None, :]
    q = rng.normal(size=(B, n)) * d
    lb = -np.abs(rng.normal(size=(B, n)))
    ub = np.abs(rng.normal(size=(B, n)))
    return P, q, lb, ub


def warm_start(B, n, seed):
    """x0, y0 and a carried rho0 whose lane 0 keeps the cold sentinel 0."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, n)) * 0.3, rng.normal(size=(B, n)) * 0.5,
            np.concatenate([[0.0], rng.uniform(0.5, 5.0, B - 1)]))


def jax_solve(P, q, lb, ub, x0, y0, rho0, params):
    """Vmapped JAX solve_boxqp_fixed; None warm starts become the cold
    defaults (zeros)."""
    B, n = q.shape
    return jax.vmap(lambda P, q, lb, ub, x0, y0, r0: solve_boxqp_fixed(
        P, q, lb, ub, x0=x0, params=params, y0=y0, rho0=r0))(
        *map(jnp.asarray, (P, q, lb, ub, np.zeros((B, n)) if x0 is None else x0,
                           np.zeros((B, n)) if y0 is None else y0,
                           np.zeros(B) if rho0 is None else rho0)))


def riccati_batch(B, H, dx, du, seed):
    """B condensed box QPs of random complex LTV horizons with shared costs
    (float64), and their real-embedded LQR data (Ar (B, H, m, m), Br, Qr,
    Rr), as the reference's kernel route hands them to the inverse."""
    from mpc4quantum_tpu_torch.solvers.condense import qp_data
    from mpc4quantum_tpu_torch.solvers.riccati import embed_costs, embed_ltv

    rng = np.random.default_rng(seed)
    cx = lambda *shape: rng.normal(size=shape) + 1j * rng.normal(size=shape)
    A_s = torch.tensor(0.3 * cx(B, H, dx, dx) + np.eye(dx))
    B_s = torch.tensor(0.5 * cx(B, H, dx, du))
    W = cx(H + 1, dx, dx)
    Q_s = torch.tensor(W @ np.conj(np.swapaxes(W, 1, 2)))
    G = rng.normal(size=(H, du, du))
    R_s = torch.tensor(G @ np.swapaxes(G, 1, 2) + 0.1 * np.eye(du))
    P, q, lb, ub, _, _ = qp_data(torch.tensor(cx(B, dx)), torch.tensor(cx(dx, H + 1)),
                                 torch.tensor(rng.normal(size=(du, H))), Q_s, R_s, A_s, B_s,
                                 torch.zeros(B, H, dx, dtype=torch.complex128), sat=1.0)
    lqr = embed_ltv(A_s, B_s) + embed_costs(Q_s, R_s)
    return (P.numpy(), q.numpy(), lb.numpy(), ub.numpy(), tuple(t.numpy() for t in lqr))


def assert_matches_jax(z, y, aux, ref, acc, tol):
    for ours, theirs in ((z, ref.x), (y, ref.y), (aux.rho, ref.rho),
                         (aux.prim, ref.prim_res), (aux.dual, ref.dual_res)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0, atol=tol)
    conv = boxqp_accept(aux, 1e-6, 1e-6, acc, acc)
    np.testing.assert_array_equal(conv.numpy(), np.asarray(ref.converged))


# (iters, rounds, acceptance, warm start, scale): the flagship's cold
# warm-phase form, its dual-warm-started steady form, and that form
# Jacobi-scaled
FORMS = {"cold_3x12": (12, 3, 1e-3, False, False), "warm_2x10": (10, 2, 4e-3, True, False),
         "warm_2x10_scaled": (10, 2, 4e-3, True, True)}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_boxqp_ref_matches_jax_solve_boxqp_fixed(form):
    iters, rounds, acc, warm, scale = FORMS[form]
    B, n = 8, 10
    P, q, lb, ub = spread_batch(B, n, seed=1) if scale else make_batch(B, n, seed=1)
    rng = np.random.default_rng(7)
    x0 = rng.normal(size=(B, n)) * 0.3
    y0 = rng.normal(size=(B, n)) * 0.5 if warm else None
    # positive carried rho on most lanes; lane 0 keeps the cold sentinel 0
    rho0 = np.concatenate([[0.0], rng.uniform(0.5, 5.0, B - 1)]) if warm else None

    params = JBoxQPParams(max_iter=iters, n_rounds=rounds, accept_abs=acc, accept_rel=acc,
                          kinv="gj", unroll=False, scale=scale)
    ref = jax_solve(P, q, lb, ub, x0, y0, rho0, params)
    t = lambda a: None if a is None else torch.tensor(a)
    z, y, aux = boxqp_small_ref(t(P), t(q), t(lb), t(ub), t(x0), t(y0), t(rho0),
                                iters=iters, rounds=rounds, acc_abs=acc, acc_rel=acc,
                                scale=scale)
    assert_matches_jax(z, y, aux, ref, acc, TOL)
    # the comparison is not vacuous: box constraints bind on some lanes (the
    # scaled form unscales z, so a bound holds there to rounding)
    assert bool((((z - t(lb)).abs() < 1e-12) | ((z - t(ub)).abs() < 1e-12)).any())


def test_boxqp_small_ref_scaled_matches_pallas_interpret():
    """The scaled form against the Pallas kernel itself, in float32 on both
    sides: 2e-5 on z and the primal residual, 2e-4 on y and the dual one
    (the JAX package's own tolerances for the kernel against its mirror;
    the sums run in different orders). A tiny budget bounds the unrolled
    kernel's interpret-mode compile."""
    B, n, iters, rounds = 8, 4, 4, 2
    P, q, lb, ub = (a.astype(np.float32) for a in spread_batch(B, n, seed=5))
    x0, y0, rho0 = (a.astype(np.float32) for a in warm_start(B, n, seed=6))
    zk, aux_k = boxqp_pallas(*map(jnp.asarray, (P, q, lb, ub)), x0=jnp.asarray(x0),
                             y0=jnp.asarray(y0), rho0=jnp.asarray(rho0), iters=iters,
                             rounds=rounds, interpret=True, return_aux=True, scale=True,
                             tile_b=128, sublanes=1)
    t = torch.tensor
    z, y, aux = boxqp_small_ref(t(P), t(q), t(lb), t(ub), t(x0), t(y0), t(rho0),
                                iters=iters, rounds=rounds, scale=True)
    for ours, theirs, tol in ((z, zk, 2e-5), (y, aux_k.y, 2e-4), (aux.prim, aux_k.prim, 2e-5),
                              (aux.dual, aux_k.dual, 2e-4)):
        scale = max(1.0, float(np.abs(np.asarray(theirs)).max()))
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0, atol=tol * scale)
    np.testing.assert_allclose(aux.rho.numpy(), np.asarray(aux_k.rho), rtol=1e-3)


@pytest.mark.parametrize("n", [32, 50])
def test_admm_iters_ref_matches_pallas_interpret(n):
    """The large-n ADMM kernel's plain version against the Pallas kernel
    itself, float32 on both sides, within 1e-5 relative to max(1, |ref|):
    the row sums run in different orders. The kernel wants lanes last and
    padded to 128 lanes; the pad lanes are set as boxqp_pallas_big sets
    them (identity inverse, q = 0, box [-1, 1], zero iterates)."""
    B, Bp, iters, sigma, alpha = 8, 128, 50, 1e-6, 1.6
    P, q, lb, ub = make_batch(B, n, seed=n)
    P = P / n
    rng = np.random.default_rng(n + 1)
    rho = rng.uniform(0.05, 2.0, B)
    kinv = np.linalg.inv(P + (sigma + rho)[:, None, None] * np.eye(n))
    x, z, y = (rng.normal(size=(B, n)) * s for s in (0.3, 0.3, 0.5))
    f32 = lambda a: np.asarray(a, np.float32)
    pad = lambda a, fill: np.concatenate([a, np.full((Bp - B,) + a.shape[1:], fill)])
    kinv_p = np.concatenate([kinv, np.broadcast_to(np.eye(n), (Bp - B, n, n))])
    lanes = lambda a, fill: jnp.asarray(f32(pad(a, fill)).T)
    ref = _admm_iters_lanes(jnp.asarray(f32(kinv_p)), lanes(q, 0.0), lanes(lb, -1.0),
                            lanes(ub, 1.0), jnp.asarray(f32(pad(rho, 0.1))[None, :]),
                            lanes(x, 0.0), lanes(z, 0.0), lanes(y, 0.0), iters=iters,
                            sigma=sigma, alpha=alpha, interpret=True)
    t = lambda a: torch.tensor(f32(a))
    ours = admm_iters_ref(t(kinv), t(q), t(lb), t(ub), t(rho), t(x), t(z), t(y),
                          iters=iters, sigma=sigma, alpha=alpha)
    for o, r in zip(ours, ref):
        r = np.asarray(r)[:, :B].T
        np.testing.assert_allclose(o.numpy(), r, rtol=0, atol=1e-5 * max(1.0, np.abs(r).max()))
    # not vacuous: the box binds and the iterates moved
    assert bool(((ours[1] == t(lb)) | (ours[1] == t(ub))).any())
    assert float((ours[0] - t(x)).abs().max()) > 0.1


def test_ns_inverse_matches_jax():
    rng = np.random.default_rng(3)
    B, n = 4, 24
    G = rng.normal(size=(B, n, n))
    K = np.einsum("bij,bkj->bik", G, G) / n + 0.3 * np.eye(n)
    ours = ns_inverse(torch.tensor(K), iters=20).numpy()
    np.testing.assert_allclose(ours, np.asarray(jax_ns_inverse(jnp.asarray(K), iters=20)),
                               rtol=0, atol=1e-12)
    # and it is an inverse at that budget
    np.testing.assert_allclose(ours @ K, np.broadcast_to(np.eye(n), K.shape), atol=1e-8)


def test_jacobi_scale_matches_jax():
    P, q, lb, ub = spread_batch(4, 12, seed=4)
    x0, y0, _ = warm_start(4, 12, seed=5)
    ours = jacobi_scale_boxqp(*map(torch.tensor, (P, q, lb, ub, x0, y0)))
    theirs = jax_jacobi_scale(*map(jnp.asarray, (P, q, lb, ub, x0, y0)))
    for o, t in zip(ours, theirs):
        np.testing.assert_allclose(o.numpy(), np.asarray(t), rtol=1e-14, atol=0)
    np.testing.assert_allclose(torch.diagonal(ours[0], dim1=1, dim2=2).numpy(), 1.0, rtol=1e-14)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("scale", [False, True], ids=["unscaled", "scaled"])
@pytest.mark.parametrize("kinv", ["gj", "ns"])
def test_boxqp_big_matches_jax_solve_boxqp_fixed(kinv, scale, warm):
    """boxqp_big (the host side of the large-n kernel, with admm_big's plain
    version on the CPU) against the vmapped JAX solve_boxqp_fixed in float64
    at 1e-10, both inverse forms, scaled and not, cold and warm-started."""
    B, n, iters, rounds, acc = 6, 24, 30, 2, 4e-3
    P, q, lb, ub = spread_batch(B, n, seed=11)
    x0, y0, rho0 = warm_start(B, n, seed=12) if warm else (None, None, None)
    params = JBoxQPParams(max_iter=iters, n_rounds=rounds, accept_abs=acc, accept_rel=acc,
                          kinv=kinv, ns_iters=30, unroll=False, scale=scale)
    ref = jax_solve(P, q, lb, ub, x0, y0, rho0, params)
    t = lambda a: None if a is None else torch.tensor(a)
    admm_big.launches = 0
    z, y, aux, kinv_out, guard_cold = boxqp_big(
        t(P), t(q), t(lb), t(ub), t(x0), t(y0), t(rho0), iters=iters, rounds=rounds,
        acc_abs=acc, acc_rel=acc, scale=scale, kinv_method=kinv, ns_iters=30)
    assert_matches_jax(z, y, aux, ref, acc, TOL)
    np.testing.assert_allclose(kinv_out.numpy(), np.asarray(ref.kinv), rtol=0, atol=TOL)
    assert guard_cold is None
    assert admm_big.launches == 0
    assert bool((((z - t(lb)).abs() < 1e-12) | ((z - t(ub)).abs() < 1e-12)).any())


def hermitian_generators(B, d, rng):
    """-i H for random Hermitian d x d H: the quantum plants' step generators."""
    G = rng.normal(size=(B, d, d)) + 1j * rng.normal(size=(B, d, d))
    return -0.5j * (G + np.conj(np.swapaxes(G, 1, 2)))


def liouvillian_generators(B, rng):
    """Non-normal 4 x 4 generators shaped like the Lindblad plant's
    dt (A0 + u A1) on row-major vec(rho): A0 = -i[H0, .] + D[L] with the
    amplitude-damping L = sqrt(gamma) sigma_-, A1 = -i[H1, .], for random
    Hermitian H0, H1, a rate gamma and a control u per matrix (as
    chip_smoke.liouvillian_batch builds them)."""
    herm = lambda G: 0.5 * (G + np.conj(np.swapaxes(G, 1, 2)))
    crandn = lambda: rng.normal(size=(B, 2, 2)) + 1j * rng.normal(size=(B, 2, 2))
    kron = lambda X, Y: np.einsum("bij,bkl->bikjl", X, Y).reshape(B, 4, 4)
    eye = np.broadcast_to(np.eye(2), (B, 2, 2))
    comm = lambda H: -1j * (kron(H, eye) - kron(eye, np.swapaxes(H, 1, 2)))
    L = np.sqrt(rng.uniform(0.05, 0.5, size=(B, 1, 1))) * np.array([[0.0, 1.0], [0.0, 0.0]])
    LdL = np.conj(np.swapaxes(L, 1, 2)) @ L
    D = kron(L, np.conj(L)) - 0.5 * (kron(LdL, eye) + kron(eye, np.swapaxes(LdL, 1, 2)))
    return comm(herm(crandn())) + D + rng.uniform(-1, 1, size=(B, 1, 1)) * comm(herm(crandn()))


# (taylor_k, max_squarings, norm_lo, norm_hi, d): the flagship's certified
# form (||A||_1 <= 0.8), the any-norm default (up to 10 squarings), drag's
# d = 3 form and lindblad's d = 4 form on Liouvillians across its 0- and
# 1-squaring branches
EXPM_FORMS = [(12, 0, 1e-3, 0.8, 2), (18, 12, 0.25, 2.0 ** 10, 2), (12, 2, 0.05, 2.0, 3),
              (12, 1, 0.05, 1.6, 4)]


@pytest.mark.parametrize("taylor_k,max_squarings,norm_lo,norm_hi,d", EXPM_FORMS,
                         ids=["-".join(map(str, f[:4])) for f in EXPM_FORMS])
def test_expm_ref_matches_pallas_interpret(taylor_k, max_squarings, norm_lo, norm_hi, d):
    rng = np.random.default_rng(taylor_k + d - 2)
    B = 6
    A = liouvillian_generators(B, rng) if d == 4 else hermitian_generators(B, d, rng)
    norms = np.exp(np.linspace(np.log(norm_lo), np.log(norm_hi), B))
    A = A * (norms / np.abs(A).sum(axis=1).max(axis=1))[:, None, None]
    # at d = 4 one sublane: the same kernel on a lanes-only layout, whose
    # unrolled interpret-mode trace compiles in a quarter of the time there
    ref = np.asarray(expm_pallas(jnp.asarray(A), max_squarings=max_squarings, taylor_k=taylor_k,
                                 tile_b=128, sublanes=1 if d == 4 else 8, interpret=True))
    ours = expm_small_ref(torch.tensor(A), taylor_k=taylor_k, max_squarings=max_squarings)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=TOL)
    if d == 4:
        # both branches, and a check on both that needs no oracle: exp of a
        # Liouvillian preserves the trace, vec(I)^T E = vec(I)^T
        assert 0 < int((norms > 1).sum()) < B
        trace = np.eye(2).reshape(4)
        np.testing.assert_allclose(trace @ ref, np.broadcast_to(trace, (B, 4)), atol=1e-9)
    else:
        # unitary (exp of anti-Hermitian)
        eye = np.eye(d)
        np.testing.assert_allclose(ref @ np.conj(np.swapaxes(ref, 1, 2)),
                                   np.broadcast_to(eye, ref.shape), atol=1e-9 * norm_hi)


def test_wrappers_take_the_plain_version_on_cpu():
    boxqp_small.launches = expm_small.launches = admm_big.launches = 0
    P, q, lb, ub = (torch.tensor(a) for a in make_batch(4, 6, seed=2))
    for scale in (False, True):
        kw = dict(iters=5, rounds=2, scale=scale)
        for a, b in zip(boxqp_small(P, q, lb, ub, **kw), boxqp_small_ref(P, q, lb, ub, **kw)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    A = torch.randn(5, 2, 2, dtype=torch.complex128, generator=torch.Generator().manual_seed(0))
    A = A * (0.5 / A.abs().sum(dim=-2).amax())
    torch.testing.assert_close(expm_small(A, 12, 0), expm_small_ref(A, 12, 0), rtol=0, atol=0)
    kinv = torch.linalg.inv(P + torch.eye(6))
    args = (kinv, q, lb, ub, torch.ones(4), q, q, q)
    for a, b in zip(admm_big(*args, iters=3, sigma=1e-6, alpha=1.6),
                    admm_iters_ref(*args, iters=3, sigma=1e-6, alpha=1.6)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    boxqp_big(P, q, lb, ub, iters=5, rounds=2, kinv_method="gj")
    assert boxqp_small.launches == 0 and expm_small.launches == 0 and admm_big.launches == 0


def test_wrappers_raise_instead_of_falling_back():
    P, q, lb, ub = (torch.tensor(a) for a in make_batch(2, 4, seed=3))
    meta = lambda t: t.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        boxqp_small(meta(P), meta(q), meta(lb), meta(ub), iters=2, rounds=1)
    with pytest.raises(ValueError, match="unsupported device"):
        expm_small(torch.zeros(2, 2, 2, dtype=torch.complex64, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        admm_big(meta(P), *(meta(t) for t in (q, lb, ub, q[:, 0], q, q, q)), iters=1,
                 sigma=1e-6, alpha=1.6)
    # the Riccati inverse without the LTV problem it factors raises, and
    # does not fall back to Newton-Schulz
    with pytest.raises(ValueError, match="lqr_data"):
        boxqp_big(P, q, lb, ub, iters=2, rounds=1, kinv_method="riccati")
    # the K-inverse options run as the reference's: the carried inverse
    # (kinv0), the Riccati inverse and the warm-started Newton-Schulz (X0)
    Pn, qn, lbn, ubn = (a.numpy() for a in (P, q, lb, ub))
    params = JBoxQPParams(max_iter=2, n_rounds=2, unroll=False, ns_iters=30)
    ref = jax_solve(Pn, qn, lbn, ubn, None, None, None, params)
    kinv0 = ref.kinv + 1e-3 * np.eye(4)
    ref_c = jax.vmap(lambda P, q, lb, ub, k0: solve_boxqp_fixed(
        P, q, lb, ub, params=params, kinv0=k0))(*map(jnp.asarray, (Pn, qn, lbn, ubn, kinv0)))
    ours = boxqp_big(P, q, lb, ub, iters=2, rounds=2, kinv0=torch.tensor(kinv0))
    for o, r in ((ours.z, ref_c.x), (ours.y, ref_c.y), (ours.aux.rho, ref_c.rho),
                 (ours.kinv, ref_c.kinv)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=TOL)
    assert not bool(ours.guard_cold.any())
    Pr, qr, lbr, ubr, lqr = riccati_batch(2, H=2, dx=2, du=2, seed=3)
    params = JBoxQPParams(max_iter=5, n_rounds=2, unroll=False, kinv="riccati")
    ref_r = jax.vmap(lambda P, q, lb, ub, A, B: solve_boxqp_fixed(
        P, q, lb, ub, params=params, lqr_data=(A, B, lqr[2], lqr[3])))(
        *map(jnp.asarray, (Pr, qr, lbr, ubr, lqr[0], lqr[1])))
    ours = boxqp_big(*map(torch.tensor, (Pr, qr, lbr, ubr)), iters=5, rounds=2,
                     kinv_method="riccati", lqr_data=tuple(map(torch.tensor, lqr)))
    for o, r in ((ours.z, ref_r.x), (ours.y, ref_r.y), (ours.kinv, ref_r.kinv)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=TOL)
    X = ns_inverse(P + torch.eye(4), iters=2, X0=P)
    np.testing.assert_allclose(X.numpy(), np.asarray(jax_ns_inverse(
        jnp.asarray(Pn + np.eye(4)), iters=2, X0=jnp.asarray(Pn))), rtol=0, atol=TOL)


def test_expm_norm_guard_at_zero_squarings():
    """(12, 0) is the certified form: ||A||_1 <= 1 for every matrix. A
    matrix past it would come back silently non-unitary, so the plain
    version refuses it; the any-norm form takes it."""
    rng = np.random.default_rng(2)
    G = rng.normal(size=(3, 2, 2)) + 1j * rng.normal(size=(3, 2, 2))
    A = -0.5j * (G + np.conj(np.swapaxes(G, 1, 2)))
    A = torch.tensor(A * (3.0 / np.abs(A).sum(axis=1).max(axis=1))[:, None, None])
    with pytest.raises(ValueError, match="max_squarings = 0"):
        expm_small(A, taylor_k=12, max_squarings=0)
    E = expm_small(A, taylor_k=18, max_squarings=12)
    eye = torch.eye(2, dtype=E.dtype).expand_as(E)
    torch.testing.assert_close(E @ E.conj().transpose(1, 2), eye, rtol=0, atol=1e-12)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "_CUDA_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "_BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library()
    assert not (tmp_path / "build").exists()
