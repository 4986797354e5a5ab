"""The CUDA kernels against their plain versions, on the card.

These tests need a CUDA device, nvcc and the card's build of PyTorch; they
skip elsewhere. The file imports no JAX, so it also runs where JAX is not
installed; tests/conftest.py imports JAX, so there run it with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from mpc4quantum_tpu_torch.kernels.boxqp import boxqp_accept, boxqp_small, boxqp_small_ref
from mpc4quantum_tpu_torch.kernels.expm import expm_small, expm_small_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 4, 10, 15, 16])
def test_boxqp_kernel_matches_plain(cuda, n):
    B = 300  # not a multiple of the block size: the ragged edge is masked
    rng = np.random.default_rng(n)
    G = rng.normal(size=(B, n, n))
    P = np.einsum("bij,bkj->bik", G, G) + 0.5 * np.eye(n)
    q, lb, ub = rng.normal(size=(B, n)) * 2, -np.abs(rng.normal(size=(B, n))), np.abs(rng.normal(size=(B, n)))
    P, q, lb, ub = (torch.tensor(a, dtype=torch.float32, device=cuda) for a in (P, q, lb, ub))
    before = boxqp_small.launches
    zk, yk, ak = boxqp_small(P, q, lb, ub, iters=12, rounds=3)
    zp, yp, ap = boxqp_small_ref(P, q, lb, ub, iters=12, rounds=3)
    torch.cuda.synchronize()
    assert boxqp_small.launches == before + 1
    torch.testing.assert_close(zk, zp, rtol=0, atol=1e-3)
    torch.testing.assert_close(yk, yp, rtol=0, atol=1e-3 * max(1.0, float(yp.abs().max())))
    assert bool((boxqp_accept(ak, 1e-6, 1e-6, 1e-3, 1e-3) == boxqp_accept(ap, 1e-6, 1e-6, 1e-3, 1e-3)).all())


@pytest.mark.parametrize("d", [2, 3, 4])
@pytest.mark.parametrize("taylor_k,max_squarings", [(12, 0), (18, 12)])
def test_expm_kernel_matches_plain(cuda, d, taylor_k, max_squarings):
    B = 300
    rng = np.random.default_rng(d)
    G = rng.normal(size=(B, d, d)) + 1j * rng.normal(size=(B, d, d))
    A = -0.5j * (G + np.conj(np.swapaxes(G, 1, 2)))
    hi = 0.8 if max_squarings == 0 else 64.0
    A = A * (hi * rng.uniform(0.01, 1, B) / np.abs(A).sum(axis=1).max(axis=1))[:, None, None]
    A = torch.tensor(A, dtype=torch.complex64, device=cuda)
    Ek = expm_small(A, taylor_k, max_squarings)
    Ep = expm_small_ref(A, taylor_k, max_squarings)
    torch.testing.assert_close(Ek, Ep, rtol=0, atol=1e-5 if max_squarings == 0 else 1e-4)


def test_kernels_refuse_what_they_do_not_take(cuda):
    with pytest.raises(ValueError, match="complex64"):
        expm_small(torch.zeros(4, 5, 5, dtype=torch.complex64, device=cuda))
    P = torch.eye(17, device=cuda).expand(2, 17, 17)
    v = torch.zeros(2, 17, device=cuda)
    with pytest.raises(ValueError, match="n <= 16"):
        boxqp_small(P, v, v, v, iters=1, rounds=1)
    with pytest.raises(ValueError, match="float32"):
        boxqp_small(P[:, :4, :4].double(), v[:, :4], v[:, :4], v[:, :4], iters=1, rounds=1)
