"""The port's kernel modules against the JAX package, on the CPU.

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py
and chip_smoke.py hold them against these plain versions there). Here:
  - boxqp_small_ref against the vmapped JAX solve_boxqp_fixed with the
    Gauss-Jordan K-inverse (kinv="gj"), the documented iterate-for-iterate
    mirror of the Pallas QP kernel, in float64 at tolerance 1e-10;
  - expm_small_ref against the Pallas expm kernel run in interpret mode, in
    complex128 at tolerance 1e-10 relative to the largest entry;
  - the wrappers take the plain version on CPU tensors and count no launch.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mpc4quantum_tpu.ops.pallas_expm import expm_pallas
from mpc4quantum_tpu.solvers.boxqp import BoxQPParams as JBoxQPParams, solve_boxqp_fixed

from mpc4quantum_tpu_torch.kernels import _build
from mpc4quantum_tpu_torch.kernels.boxqp import boxqp_accept, boxqp_small, boxqp_small_ref
from mpc4quantum_tpu_torch.kernels.expm import expm_small, expm_small_ref

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


# (iters, rounds, acceptance, warm start): the flagship's cold warm-phase
# form and its dual-warm-started steady form
FORMS = {"cold_3x12": (12, 3, 1e-3, False), "warm_2x10": (10, 2, 4e-3, True)}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_boxqp_ref_matches_jax_solve_boxqp_fixed(form):
    iters, rounds, acc, warm = FORMS[form]
    B, n = 8, 10
    P, q, lb, ub = make_batch(B, n, seed=1)
    rng = np.random.default_rng(7)
    x0 = rng.normal(size=(B, n)) * 0.3
    y0 = rng.normal(size=(B, n)) * 0.5 if warm else None
    # positive carried rho on most lanes; lane 0 keeps the cold sentinel 0
    rho0 = np.concatenate([[0.0], rng.uniform(0.5, 5.0, B - 1)]) if warm else None

    params = JBoxQPParams(max_iter=iters, n_rounds=rounds, accept_abs=acc, accept_rel=acc,
                          kinv="gj", unroll=False)
    ref = jax.vmap(lambda P, q, lb, ub, x0, y0, r0: solve_boxqp_fixed(
        P, q, lb, ub, x0=x0, params=params, y0=y0, rho0=r0))(
        *map(jnp.asarray, (P, q, lb, ub, x0,
                           np.zeros((B, n)) if y0 is None else y0,
                           np.zeros(B) if rho0 is None else rho0)))
    t = lambda a: None if a is None else torch.tensor(a)
    z, y, aux = boxqp_small_ref(t(P), t(q), t(lb), t(ub), t(x0), t(y0), t(rho0),
                                iters=iters, rounds=rounds, acc_abs=acc, acc_rel=acc)
    conv = boxqp_accept(aux, 1e-6, 1e-6, acc, acc)
    for ours, theirs in ((z, ref.x), (y, ref.y), (aux.rho, ref.rho),
                         (aux.prim, ref.prim_res), (aux.dual, ref.dual_res)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0, atol=TOL)
    np.testing.assert_array_equal(conv.numpy(), np.asarray(ref.converged))
    # the comparison is not vacuous: box constraints bind on some lanes
    assert bool(((z == t(lb)) | (z == t(ub))).any())


@pytest.mark.parametrize("taylor_k,max_squarings,norm_lo,norm_hi", [
    (12, 0, 1e-3, 0.8),        # the flagship's certified form (||A||_1 <= 0.8)
    (18, 12, 0.25, 2.0 ** 10),  # the any-norm default, up to 10 squarings
])
def test_expm_ref_matches_pallas_interpret(taylor_k, max_squarings, norm_lo, norm_hi):
    rng = np.random.default_rng(taylor_k)
    B, d = 6, 2
    G = rng.normal(size=(B, d, d)) + 1j * rng.normal(size=(B, d, d))
    A = -0.5j * (G + np.conj(np.swapaxes(G, 1, 2)))
    norms = np.exp(np.linspace(np.log(norm_lo), np.log(norm_hi), B))
    A = A * (norms / np.abs(A).sum(axis=1).max(axis=1))[:, None, None]
    ref = np.asarray(expm_pallas(jnp.asarray(A), max_squarings=max_squarings, taylor_k=taylor_k,
                                 tile_b=128, interpret=True))
    ours = expm_small_ref(torch.tensor(A), taylor_k=taylor_k, max_squarings=max_squarings)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=TOL)
    # unitary (exp of anti-Hermitian): a check on both that needs no oracle
    eye = np.eye(d)
    np.testing.assert_allclose(ref @ np.conj(np.swapaxes(ref, 1, 2)), np.broadcast_to(eye, ref.shape),
                               atol=1e-9 * norm_hi)


def test_wrappers_take_the_plain_version_on_cpu():
    boxqp_small.launches = expm_small.launches = 0
    P, q, lb, ub = (torch.tensor(a) for a in make_batch(4, 6, seed=2))
    kw = dict(iters=5, rounds=2)
    for a, b in zip(boxqp_small(P, q, lb, ub, **kw), boxqp_small_ref(P, q, lb, ub, **kw)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    A = torch.randn(5, 2, 2, dtype=torch.complex128, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(expm_small(A, 12, 0), expm_small_ref(A, 12, 0), rtol=0, atol=0)
    assert boxqp_small.launches == 0 and expm_small.launches == 0


def test_wrappers_raise_instead_of_falling_back():
    P, q, lb, ub = (torch.tensor(a) for a in make_batch(2, 4, seed=3))
    with pytest.raises(NotImplementedError, match="Jacobi-scaled"):
        boxqp_small(P, q, lb, ub, iters=2, rounds=1, scale=True)
    meta = lambda t: t.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        boxqp_small(meta(P), meta(q), meta(lb), meta(ub), iters=2, rounds=1)
    with pytest.raises(ValueError, match="unsupported device"):
        expm_small(torch.zeros(2, 2, 2, dtype=torch.complex64, device="meta"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "_CUDA_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "_BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library()
    assert not (tmp_path / "build").exists()
