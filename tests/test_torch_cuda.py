"""The CUDA kernels against their plain versions, on the card.

These tests need a CUDA device, nvcc and the card's build of PyTorch; they
skip elsewhere. The file imports no JAX, so it also runs where JAX is not
installed; tests/conftest.py imports JAX, so there run it with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from mpc4quantum_tpu_torch.kernels import _build
from mpc4quantum_tpu_torch.kernels import admm_big as admm_mod
from mpc4quantum_tpu_torch.kernels import expm as expm_mod
from mpc4quantum_tpu_torch.kernels._graph import graph_kernel_launches, graph_node_types
from mpc4quantum_tpu_torch.kernels.admm_big import STREAM_SMEM_MAX_N, admm_big, admm_iters_ref
from mpc4quantum_tpu_torch.kernels.boxqp import (boxqp_accept, boxqp_big, boxqp_small,
                                                 boxqp_small_ref)
from mpc4quantum_tpu_torch.kernels.expm import expm_small, expm_small_ref
from mpc4quantum_tpu_torch.solvers.boxqp import BoxQPParams, solve_boxqp_fixed
from mpc4quantum_tpu_torch.utils.linalg import gj_inverse

pytestmark = pytest.mark.cuda

# the expm kernel's instances: 2-4 (one team of 2 or 4 threads), 5-8 (a
# team of 8, the 3-qubit plant's d = 8), the tile instance at d = 1 and
# 9-32 (the damped pair's Liouvillian d = 16, a partial tile at d = 17),
# the cluster instance at d 33-116 (one cluster of CTAs a matrix), the
# cluster2d instance at d 117-256 (a cluster of 16 CTAs a matrix, tiles of
# 32 at d 117 and 128, of 48 at d 129 in a cluster of 9, of 64 at d 256, the
# damped four-qubit chain's Liouvillian) and the grid2d instance above (one
# cooperative launch on a workspace, d 300)
EXPM_SIZES = [1, *range(2, 9), 9, 16, 17, 32, 33, 64, 100, 116, 117, 128, 129, 256, 300]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def qp_batch(B, n, seed, device, spread=0.0):
    """SPD box QPs in float32 on `device`; spread > 0 spreads the diagonal
    over orders of magnitude, where Jacobi scaling matters."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(B, n, n))
    P = np.einsum("bij,bkj->bik", G, G) / max(1, n // 10) + 0.5 * np.eye(n)
    d = np.exp(rng.normal(scale=spread, size=(B, n)))
    P = P * d[:, :, None] * d[:, None, :]
    q = rng.normal(size=(B, n)) * 2 * d
    lb, ub = -np.abs(rng.normal(size=(B, n))), np.abs(rng.normal(size=(B, n)))
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in (P, q, lb, ub)]


def hermitian_batch(B, d, seed, hi, device):
    """-i H for random Hermitian H, 1-norms in [0.01 hi, hi], complex64."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(B, d, d)) + 1j * rng.normal(size=(B, d, d))
    A = -0.5j * (G + np.conj(np.swapaxes(G, 1, 2)))
    A = A * (hi * rng.uniform(0.01, 1, B) / np.abs(A).sum(axis=1).max(axis=1))[:, None, None]
    # row-major, as the plants hand it to the kernel (numpy may keep the
    # swapped axes' order in the result)
    return torch.tensor(np.ascontiguousarray(A), dtype=torch.complex64, device=device)


@pytest.mark.parametrize("n", range(1, 17))
def test_boxqp_kernel_matches_plain(cuda, n):
    B = 300  # not a multiple of the QPs in a block: the ragged edge is masked
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


@pytest.mark.parametrize("n", range(1, 17))
def test_boxqp_kernel_scaled_matches_plain(cuda, n):
    B = 300
    P, q, lb, ub = qp_batch(B, n, seed=n, device=cuda, spread=1.0)
    zk, yk, ak = boxqp_small(P, q, lb, ub, iters=10, rounds=2, scale=True)
    zp, yp, ap = boxqp_small_ref(P, q, lb, ub, iters=10, rounds=2, scale=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(zk, zp, rtol=0, atol=1e-3 * max(1.0, float(zp.abs().max())))
    torch.testing.assert_close(yk, yp, rtol=0, atol=1e-3 * max(1.0, float(yp.abs().max())))
    torch.testing.assert_close(ak.prim, ap.prim, rtol=1e-2, atol=1e-5)


@pytest.mark.parametrize("n", [1, 17, 31, 32, 33, 50, 64, 65, 128, 129, 150, 160, 161, 239,
                               240, 241, 256, 320, 416, 417, 512, 736, 737, 750, 801, 1008,
                               1009, 1024])
def test_admm_kernel_matches_plain(cuda, n):
    """Every instance and its edges: a warp per lane up to 32 columns, whole
    rows in registers up to 64, rows split over 2 threads up to 128 and over
    4 up to 160, then 32 columns of each part in registers and the rest in
    shared memory (above 48 KB of it at n = 239); from n = 240 the cluster
    instance (a cluster of CTAs a lane, 2 CTAs up to n 416, 3 from 417, 8
    at 736, 10 at 737-800 (cnot_h250's 750), 11 from 801, 16 at 1008; n
    not a multiple of four at 241), and from n = 1009 the streaming
    instance (a cluster of 16 CTAs a lane, each reading its rows from
    device memory every iteration, four rows a warp). Split, clustered and
    streamed rows add their parts in another order than the plain row sum:
    float32 rounding, well inside the bound."""
    B = 300 if n < 512 else 16
    P, q, lb, ub = qp_batch(B, n, seed=n, device=cuda)
    rng = np.random.default_rng(n + 1)
    rho = torch.tensor(rng.uniform(0.05, 2.0, B), dtype=torch.float32, device=cuda)
    kinv = gj_inverse(P + (1e-6 + rho)[:, None, None] * torch.eye(n, device=cuda))
    x, z, y = (torch.tensor(rng.normal(size=(B, n)) * s, dtype=torch.float32, device=cuda)
               for s in (0.3, 0.3, 0.5))
    before = admm_big.launches
    out_k = admm_big(kinv, q, lb, ub, rho, x, z, y, iters=50, sigma=1e-6, alpha=1.6)
    out_p = admm_iters_ref(kinv, q, lb, ub, rho, x, z, y, iters=50, sigma=1e-6, alpha=1.6)
    torch.cuda.synchronize()
    assert admm_big.launches == before + 1
    for k, p in zip(out_k, out_p):
        torch.testing.assert_close(k, p, rtol=0, atol=1e-4 * max(1.0, float(p.abs().max())))


@pytest.mark.parametrize("B", [1, 4, 16, 128, 1024, 16384])
def test_library_plans_equal_the_python_plans(cuda, B):
    """mpc4q_expm_small_plan and mpc4q_admm_big_plan against
    expm_small_plan and admm_big_plan: every d in 1..160, n in 1..4096."""
    for kind, mod, top in (("expm_small", expm_mod, 160), ("admm_big", admm_mod, 4096)):
        plan_fn = getattr(mod, f"{kind}_plan")
        for size in range(1, top + 1):
            plan = plan_fn(B, size)
            assert _build.plan(kind, B, size)[:4] == (mod.INSTANCES.index(plan.instance),
                                                      *plan[1:]), (kind, B, size)


@pytest.mark.parametrize("B,d", [(128, 16), (4, 100), (16, 64), (1, 33), (4, 117), (4, 129),
                                 (128, 256), (2, 300)])
def test_expm_launch_follows_its_plan(cuda, B, d):
    """The kernel node of a captured call has the plan's block, shared
    bytes and cluster dimensions: the instance the plan names ran. The
    grid2d instance's grid is one block a tile, at most what the card holds
    at once (a cooperative launch)."""
    plan = expm_mod.expm_small_plan(B, d)
    A = hermitian_batch(B, d, seed=d, hi=2.0, device=cuda)
    (launch,) = graph_kernel_launches(lambda: expm_small(A, 12, 2))
    grid = launch.pop("grid")
    assert launch == {"block": (plan.threads, 1, 1), "smem": plan.smem,
                      "cluster": (plan.cluster, 1, 1)}
    if plan.instance == "grid2d":
        tiles = B * (-(-d // 64)) ** 2
        assert grid[1:] == (1, 1) and 1 <= grid[0] <= tiles
    else:
        assert grid == (B * plan.cluster, 1, 1)
    if plan.cluster > 1:
        assert _build.plan("expm_small", B, d, query=True)[4] >= 1


@pytest.mark.parametrize("B,n", [(128, 240), (1, 240), (16, 736), (16, 737), (16, 750),
                                 (16, 1008), (1, 1009)])
def test_admm_launch_follows_its_plan(cuda, B, n):
    plan = admm_mod.admm_big_plan(B, n)
    P, q, lb, ub = qp_batch(B, n, seed=n, device=cuda)
    rho = torch.full((B,), 0.5, device=cuda)
    kinv = gj_inverse(P + (1e-6 + rho)[:, None, None] * torch.eye(n, device=cuda))
    x = z = y = torch.zeros((B, n), device=cuda)
    (launch,) = graph_kernel_launches(
        lambda: admm_big(kinv, q, lb, ub, rho, x, z, y, iters=3, sigma=1e-6, alpha=1.6))
    assert launch == {"grid": (B * plan.cluster, 1, 1), "block": (plan.threads, 1, 1),
                      "smem": plan.smem, "cluster": (plan.cluster, 1, 1)}
    assert _build.plan("admm_big", B, n, query=True)[4] >= 1


def test_admm_kernel_workspace_path_matches_plain(cuda):
    """Above STREAM_SMEM_MAX_N the two rhs buffers no longer fit shared
    memory and sit in the wrapper's workspace: one lane of a random
    3.4 GB K^-1, two iterations."""
    n = STREAM_SMEM_MAX_N + 1
    g = torch.Generator(device=cuda).manual_seed(5)
    kinv = torch.randn((1, n, n), generator=g, device=cuda) / n ** 0.5
    q, x, z, y = (torch.randn((1, n), generator=g, device=cuda) for _ in range(4))
    lb, ub = -torch.ones((1, n), device=cuda), torch.ones((1, n), device=cuda)
    rho = torch.full((1,), 0.5, device=cuda)
    args = (kinv, q, lb, ub, rho, x, z, y)
    out_k = admm_big(*args, iters=2, sigma=1e-6, alpha=1.6)
    out_p = admm_iters_ref(*args, iters=2, sigma=1e-6, alpha=1.6)
    torch.cuda.synchronize()
    for k, p in zip(out_k, out_p):
        torch.testing.assert_close(k, p, rtol=0, atol=1e-4 * max(1.0, float(p.abs().max())))
    del kinv
    torch.cuda.empty_cache()


@pytest.mark.parametrize("kinv", ["gj", "ns"])
def test_boxqp_big_matches_plain_solver(cuda, kinv):
    B, n = 300, 32
    P, q, lb, ub = qp_batch(B, n, seed=7, device=cuda, spread=1.0)
    kw = dict(iters=40, rounds=2, scale=True, kinv_method=kinv, ns_iters=20)
    zk, yk, ak, *_ = boxqp_big(P, q, lb, ub, **kw)
    zp, yp, ap, *_ = solve_boxqp_fixed(P, q, lb, ub, params=BoxQPParams(
        max_iter=40, n_rounds=2, scale=True, kinv=kinv, ns_iters=20))
    torch.cuda.synchronize()
    torch.testing.assert_close(zk, zp, rtol=0, atol=1e-3 * max(1.0, float(zp.abs().max())))
    # each of the 2 rho rebalances may move rho by 2e-2 relative where prim
    # is resolved in float32; below 1e-5 it is rounding (chip_smoke.py)
    resolved = ap.prim >= 1e-5 * torch.clamp(torch.maximum(ap.xmax, ap.zmax), min=1.0)
    assert bool(resolved.any())
    torch.testing.assert_close(ak.rho[resolved], ap.rho[resolved], rtol=4e-2, atol=0)


@pytest.mark.parametrize("d", EXPM_SIZES)
@pytest.mark.parametrize("taylor_k,max_squarings", [(12, 0), (18, 12)])
def test_expm_kernel_matches_plain(cuda, d, taylor_k, max_squarings):
    A = hermitian_batch(300, d, seed=d, hi=0.8 if max_squarings == 0 else 64.0, device=cuda)
    Ek = expm_small(A, taylor_k, max_squarings)
    Ep = expm_small_ref(A, taylor_k, max_squarings)
    torch.testing.assert_close(Ek, Ep, rtol=0, atol=1e-5 if max_squarings == 0 else 1e-4)


# (taylor_k, max_squarings, largest 1-norm): the certified and the any-norm form
EXPM_FORMS = [(12, 0, 0.8), (18, 12, 64.0)]


@pytest.mark.parametrize("d", EXPM_SIZES)
@pytest.mark.parametrize("taylor_k,max_squarings,hi", EXPM_FORMS)
def test_expm_small_is_one_kernel(cuda, d, taylor_k, max_squarings, hi):
    """The kernel reads and writes the caller's (B, d, d) complex64: a call
    is one launch and nothing else on the card, no layout copies."""
    A = hermitian_batch(64, d, seed=d, hi=hi, device=cuda)
    assert graph_node_types(lambda: expm_small(A, taylor_k, max_squarings)) == [0]


@pytest.mark.parametrize("d", EXPM_SIZES)
@pytest.mark.parametrize("taylor_k,max_squarings,hi", EXPM_FORMS)
def test_expm_kernel_nan_matrix_stays_in_its_team(cuda, d, taylor_k, max_squarings, hi):
    """A NaN in one matrix makes that matrix's exponential all NaN, as the
    TPU kernel gives (its 1-norm is NaN, so is its scale; unscaled, the
    Taylor chain spreads it): the NaN-propagating max keeps it. The other
    matrices of its team's warp match the plain version."""
    B, bad = 301, 7
    A = hermitian_batch(B, d, seed=d + 20, hi=hi, device=cuda)
    A[bad, d - 1, 0] = complex(float("nan"), 0.0)
    Ek = expm_small(A, taylor_k, max_squarings)
    Ep = expm_small_ref(A, taylor_k, max_squarings)
    torch.cuda.synchronize()
    assert bool(torch.isnan(torch.view_as_real(Ek[bad])).all())
    rest = torch.arange(B, device=cuda) != bad
    assert bool(torch.isfinite(torch.view_as_real(Ek[rest])).all())
    torch.testing.assert_close(Ek[rest], Ep[rest], rtol=0,
                               atol=1e-5 if max_squarings == 0 else 1e-4)


@pytest.mark.parametrize("d", EXPM_SIZES)
def test_expm_small_takes_strided_and_conjugated_inputs(cuda, d):
    """A transposed, conjugated or not 16-byte aligned view gives the result
    of its contiguous copy: the wrapper copies only such views, and the
    kernel reads the copy."""
    A = hermitian_batch(301, d, seed=d + 30, hi=2.0, device=cuda)
    shifted = torch.empty(301 * d * d + 1, dtype=A.dtype, device=cuda)[1:].view(301, d, d)
    shifted.copy_(A)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 8
    for view in (A.transpose(1, 2), A.conj(), A.transpose(1, 2).conj(), shifted):
        Ek = expm_small(view, 12, 2)
        Ec = expm_small(view.resolve_conj().contiguous(), 12, 2)
        torch.cuda.synchronize()
        torch.testing.assert_close(Ek, Ec, rtol=0, atol=0)


@pytest.mark.parametrize("d", EXPM_SIZES)
@pytest.mark.parametrize("B", [1, 33, 301])
def test_expm_kernel_ragged_batch_matches_plain(cuda, d, B):
    """B not a multiple of the team or of a block of any size: the teams
    past the end store nothing, every matrix up to B is written."""
    A = hermitian_batch(B, d, seed=B + d, hi=2.0, device=cuda)
    before = expm_small.launches
    Ek = expm_small(A, 12, 2)
    Ep = expm_small_ref(A, 12, 2)
    torch.cuda.synchronize()
    assert expm_small.launches == before + 1
    torch.testing.assert_close(Ek, Ep, rtol=0, atol=1e-5)


@pytest.mark.parametrize("d", [2, 3, 4, 9, 16])
def test_expm_kernel_takes_real_input(cuda, d):
    """A real float32 batch, as expm_pallas takes it: run as complex64, the
    real part returned (exp of a real matrix is real), one kernel launch."""
    rng = np.random.default_rng(d)
    A = torch.tensor(rng.normal(size=(64, d, d)) * (1.5 / d), dtype=torch.float32, device=cuda)
    before = expm_small.launches
    Ek = expm_small(A, 12, 2)
    Ep = expm_small_ref(A, 12, 2)
    torch.cuda.synchronize()
    assert Ek.dtype == torch.float32 and expm_small.launches == before + 1
    torch.testing.assert_close(Ek, Ep, rtol=0, atol=1e-5)


@pytest.mark.parametrize("scale", [False, True])
def test_boxqp_small_is_one_kernel(cuda, scale):
    """The kernel symmetrizes, equilibrates and unscales itself: a whole
    solve, warm-started, is one launch and nothing else on the card."""
    P, q, lb, ub = qp_batch(64, 10, seed=5, device=cuda, spread=1.0)
    x0, y0, rho0 = q * 0.1, q * 0.2, torch.ones(64, device=cuda)
    call = lambda: boxqp_small(P, q, lb, ub, x0, y0, rho0, iters=10, rounds=2, scale=scale)
    assert graph_node_types(call) == [0]  # one kernel node, nothing else


def test_boxqp_small_takes_strided_inputs(cuda):
    """Transposed P and strided vectors give the solve of their contiguous
    copies: the wrapper's copies live until the launch."""
    P, q, lb, ub = qp_batch(300, 10, seed=6, device=cuda)
    wide = torch.stack([q, lb, ub, q * 0.5], dim=2)  # (B, n, 4): each [..., k] is strided
    y0 = wide[..., 3]
    zk, yk, ak = boxqp_small(P.transpose(1, 2), wide[..., 0], wide[..., 1], wide[..., 2],
                             y0=y0, iters=10, rounds=2)
    zc, yc, ac = boxqp_small(P.transpose(1, 2).contiguous(), q, lb, ub, y0=y0.contiguous(),
                             iters=10, rounds=2)
    torch.cuda.synchronize()
    torch.testing.assert_close(zk, zc, rtol=0, atol=0)
    torch.testing.assert_close(ak.rho, ac.rho, rtol=0, atol=0)


@pytest.mark.parametrize("scale", [False, True])
def test_boxqp_kernel_nan_lane_is_not_accepted(cuda, scale):
    """A NaN in one lane's q gives that lane NaN residuals, which are never
    accepted, and stays in its lane: the team's other threads and the
    warp's other QPs are untouched."""
    B, n, bad = 300, 10, 7
    P, q, lb, ub = qp_batch(B, n, seed=11, device=cuda, spread=1.0 if scale else 0.0)
    q[bad, 3] = float("nan")
    zk, yk, ak = boxqp_small(P, q, lb, ub, iters=12, rounds=3, scale=scale)
    zp, yp, ap = boxqp_small_ref(P, q, lb, ub, iters=12, rounds=3, scale=scale)
    torch.cuda.synchronize()
    assert bool(torch.isnan(ak.prim[bad])) and bool(torch.isnan(ak.dual[bad]))
    flags = boxqp_accept(ak, 1e-6, 1e-6, 1e-3, 1e-3)
    assert not bool(flags[bad])
    rest = torch.arange(B, device=cuda) != bad
    assert bool(torch.isfinite(ak.prim[rest]).all() & torch.isfinite(zk[rest]).all())
    torch.testing.assert_close(zk[rest], zp[rest], rtol=0,
                               atol=1e-3 * max(1.0, float(zp[rest].abs().max())))
    assert bool((flags == boxqp_accept(ap, 1e-6, 1e-6, 1e-3, 1e-3)).all())


def test_boxqp_kernel_n15_warm_form_matches_plain(cuda):
    """not_gate's shape: n = 15 (a team of 16 threads a QP), its cold
    3x12 form and the steady 2x10 form started from the cold dual and rho."""
    B, n = 1024, 15
    P, q, lb, ub = qp_batch(B, n, seed=15, device=cuda)
    _, y0, a0 = boxqp_small_ref(P, q, lb, ub, iters=12, rounds=3)
    kw = dict(iters=10, rounds=2, acc_abs=4e-3, acc_rel=4e-3)
    zk, yk, ak = boxqp_small(P, q, lb, ub, y0=y0, rho0=a0.rho, **kw)
    zp, yp, ap = boxqp_small_ref(P, q, lb, ub, y0=y0, rho0=a0.rho, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(zk, zp, rtol=0, atol=1e-3 * max(1.0, float(zp.abs().max())))
    torch.testing.assert_close(yk, yp, rtol=0, atol=1e-3 * max(1.0, float(yp.abs().max())))
    assert bool((boxqp_accept(ak, 1e-6, 1e-6, 4e-3, 4e-3)
                 == boxqp_accept(ap, 1e-6, 1e-6, 4e-3, 4e-3)).all())


@pytest.mark.parametrize("B", [1, 48])
def test_boxqp_small_at_the_single_rollout_shapes(cuda, B):
    """mpc()'s QPs: n = 10 at B = 1 (and 48), the library's cold 2x150
    budget every solve of a single rollout takes."""
    P, q, lb, ub = qp_batch(B, 10, seed=B, device=cuda)
    before = boxqp_small.launches
    zk, yk, ak = boxqp_small(P, q, lb, ub, iters=150, rounds=2)
    zp, yp, ap = boxqp_small_ref(P, q, lb, ub, iters=150, rounds=2)
    torch.cuda.synchronize()
    assert boxqp_small.launches == before + 1
    torch.testing.assert_close(zk, zp, rtol=0, atol=1e-3 * max(1.0, float(zp.abs().max())))
    torch.testing.assert_close(yk, yp, rtol=0, atol=1e-3 * max(1.0, float(yp.abs().max())))
    assert bool((boxqp_accept(ak, 1e-6, 1e-6, 1e-3, 1e-3)
                 == boxqp_accept(ap, 1e-6, 1e-6, 1e-3, 1e-3)).all())


@pytest.mark.parametrize("B", [1, 48])
def test_expm_small_at_the_single_rollout_shapes(cuda, B):
    """The plant step of mpc() (B = 1) and quantum_simulate's one call for
    the 48-step Blackman drive (B = 48), d = 2 at (12, 0)."""
    A = hermitian_batch(B, 2, seed=B, hi=0.8, device=cuda)
    before = expm_small.launches
    Ek = expm_small(A, 12, 0)
    Ep = expm_small_ref(A, 12, 0)
    torch.cuda.synchronize()
    assert expm_small.launches == before + 1
    torch.testing.assert_close(Ek, Ep, rtol=0, atol=1e-5)
    assert graph_node_types(lambda: expm_small(A, 12, 0)) == [0]


def test_quantum_simulate_is_one_expm_launch(cuda):
    """All 48 propagators of the Blackman drive come from one launch, and
    the trajectory equals the CPU's."""
    from mpc4quantum_tpu_torch import systems
    from mpc4quantum_tpu_torch.plants.quantum import QuantumPlant, quantum_simulate

    ts = np.arange(0, 12.0, 0.25)
    us = torch.tensor(systems.blackman(ts, 0, 6.0, 0.25)[None, :])
    plant = QuantumPlant.create(0.0 * systems.SZ, [0.5 * systems.SX], device="cpu")
    x0 = torch.tensor(np.diag([1.0, 0.0]).astype(complex).flatten())
    ref = quantum_simulate(plant, x0, us, 0.25)
    before = expm_small.launches
    xs = quantum_simulate(plant.to(cuda, torch.float32), x0.to(cuda), us.to(cuda), 0.25)
    torch.cuda.synchronize()
    assert expm_small.launches == before + 1 and xs.shape == (4, 49)
    torch.testing.assert_close(xs.cpu().to(torch.complex128), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["online", "discrep"])
def test_streaming_noisy_fleet_on_the_card_tracks_the_cpu(cuda, kind):
    """8 lanes of not_state with a per-lane refit, noise at sigma 1e-5 and
    the record, on the card in float32 against float64 on the CPU with the
    same noise: the flagship's launches (26 / 20 / 0), every lane within
    1e-3 in fidelity."""
    import dataclasses

    from mpc4quantum_tpu_torch import presets
    from mpc4quantum_tpu_torch.benchfleet import fleet_fidelity, run_hostloop_fleet
    from mpc4quantum_tpu_torch.models import dmdc
    from mpc4quantum_tpu_torch.parallel.fleet import make_scenario_batch

    def scenario(**kw):
        sc = presets.not_state(**kw)
        A = sc.model.A
        model = (dmdc.online_from_bootstrap(A, 4, 4, A.shape[1] - 4) if kind == "online" else
                 dmdc.discrep_bootstrap(A, 4, 4, A.shape[1] - 4, capacity=12,
                                        rcond=10 * 12 * float(np.finfo(np.float32).eps)))
        return dataclasses.replace(sc, model=model,
                                   config=dataclasses.replace(sc.config, streaming=True))

    fit = dmdc.online_fit_iteration if kind == "online" else dmdc.discrep_fit_iteration
    sc64 = scenario(device="cpu", dtype=torch.float64)
    plants = make_scenario_batch(sc64.plant, 8, generator=torch.Generator().manual_seed(1))
    plants = dataclasses.replace(plants, sigma=plants.sigma + 1e-5)
    noise = torch.randn(20, 8, 4, dtype=torch.complex128,
                        generator=torch.Generator().manual_seed(2))
    _, ref = run_hostloop_fleet(sc64, 8, plants=plants, record=True, noise=noise,
                                model_update_fn=fit)
    sc = scenario()
    before = (boxqp_small.launches, expm_small.launches, admm_big.launches)
    _, out = run_hostloop_fleet(sc, 8, plants=plants.to(cuda, torch.float32), record=True,
                                noise=noise.to(cuda), model_update_fn=fit)
    torch.cuda.synchronize()
    after = (boxqp_small.launches, expm_small.launches, admm_big.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (26, 20, 0)
    assert out["xs"].shape == (8, 4, 21) and out["model_state"].A.device.type == "cuda"
    dfid = fleet_fidelity(sc, out["final_x"]) - fleet_fidelity(sc64, ref["final_x"])
    assert float(np.abs(dfid).max()) < 1e-3


def test_mpc_on_the_card_matches_the_cpu(cuda):
    """mpc() at B = 1 on the card in float32 against float64 on the CPU."""
    import mpc4quantum_tpu_torch as m4t
    from mpc4quantum_tpu_torch import presets

    res = {}
    for dev, dt in ((cuda, torch.float32), ("cpu", torch.float64)):
        sc = presets.not_state(device=dev, dtype=dt)
        res[dev] = m4t.mpc(sc.x0, sc.model, sc.plant, sc.X_targ, sc.U_targ, sc.Q, sc.R, sc.Qf,
                           sc.config, sc.sat, sc.du)
    card, cpu = res[cuda], res["cpu"]
    assert int(card.exit_code) == int(cpu.exit_code) == 0 and int(card.n_valid) == 20
    assert abs(float(card.xs[3, -1].real) - float(cpu.xs[3, -1].real)) < 1e-3


def test_expm_kernel_d4_liouvillian_matches_plain(cuda):
    """lindblad's form: non-normal 4 x 4 generators dt (A0 + u A1) with an
    amplitude-damping dissipator, 1-norms in [0.05, 1.6], at (12, 1): both
    the 0- and the 1-squaring branch, against the float32 and the float64
    plain versions."""
    from mpc4quantum_tpu_torch.plants.lindblad import LindbladPlant

    B = 1024
    rng = np.random.default_rng(4)
    plant = LindbladPlant.create(np.diag([0.3, -0.3]), [0.5 * np.eye(2)[::-1]],
                                 c_ops=[0.3 * np.eye(2, k=1)])
    u = torch.tensor(rng.uniform(-1, 1, size=(B, 1, 1)))
    A = plant.A0 + u * plant.A1s[0]
    norms = torch.tensor(np.exp(rng.uniform(np.log(0.05), np.log(1.6), size=B)))
    A = A * (norms / A.abs().sum(dim=-2).amax(dim=-1))[:, None, None]
    assert 0 < int((norms > 1).sum()) < B
    A32 = A.to(cuda, torch.complex64)
    Ek = expm_small(A32, 12, 1)
    torch.testing.assert_close(Ek, expm_small_ref(A32, 12, 1), rtol=0, atol=1e-5)
    E64 = expm_small_ref(A32.to(torch.complex128), 12, 1)
    torch.testing.assert_close(Ek.to(torch.complex128), E64, rtol=0, atol=1e-5)


def test_plant_steps_on_the_card_match_the_cpu(cuda):
    """The synthesis and Lindblad steps of a float32 fleet on the card
    against the float64 plain steps on the CPU."""
    from mpc4quantum_tpu_torch import presets
    from mpc4quantum_tpu_torch.parallel.fleet import make_scenario_batch

    rng = np.random.default_rng(9)
    for make, budget in ((presets.not_gate, (12, 0)), (presets.lindblad_state, (12, 1))):
        sc = make(device="cpu", dtype=torch.float64)
        plants = make_scenario_batch(sc.plant, 256)
        dim = sc.x0.shape[0]
        x = torch.tensor(rng.normal(size=(256, dim)) + 1j * rng.normal(size=(256, dim)))
        u = torch.tensor(rng.uniform(-sc.sat, sc.sat, size=(256, 1)))
        before = expm_small.launches
        out = plants.to(cuda, torch.float32).step(x.to(cuda, torch.complex64),
                                                  u.to(cuda, torch.float32), sc.config.dt, *budget)
        ref = plants.step(x, u, sc.config.dt, *budget)
        assert expm_small.launches == before + 1
        torch.testing.assert_close(out.cpu().to(torch.complex128), ref, rtol=0, atol=1e-5)


def test_three_qubit_plant_steps_on_the_card_match_the_cpu(cuda):
    """An 8-level plant (the 3-qubit problem's size: d = 8, dim_x 64) steps
    on the card through one expm_small launch at d 8 and matches the
    float64 plain step on the CPU; so do the Taylor-form free functions of
    the Lindblad and synthesis plants at d 4 (one launch each)."""
    from mpc4quantum_tpu_torch import QuantumPlant, lindblad_step_taylor, presets
    from mpc4quantum_tpu_torch.parallel.fleet import make_scenario_batch
    from mpc4quantum_tpu_torch.plants.synthesis import synthesis_step_taylor

    rng = np.random.default_rng(8)
    herm = lambda: (lambda G: 0.06 * (G + G.conj().T))(rng.normal(size=(8, 8))
                                                       + 1j * rng.normal(size=(8, 8)))
    plants = make_scenario_batch(QuantumPlant.create(herm(), [herm(), herm(), herm()],
                                                     device="cpu"), 512)
    rho = rng.normal(size=(512, 64)) + 1j * rng.normal(size=(512, 64))
    x, u = torch.tensor(rho), torch.tensor(rng.uniform(-1.0, 1.0, size=(512, 3)))
    budget = (12, 2)
    before = expm_small.launches
    out = plants.to(cuda, torch.float32).step(x.to(cuda, torch.complex64),
                                              u.to(cuda, torch.float32), 0.5, *budget)
    assert expm_small.launches == before + 1
    torch.testing.assert_close(out.cpu().to(torch.complex128), plants.step(x, u, 0.5, *budget),
                               rtol=0, atol=1e-4)
    for make, fn in ((presets.lindblad_state, lindblad_step_taylor),
                     (presets.not_gate, synthesis_step_taylor)):
        sc = make(device="cpu", dtype=torch.float64)
        dim = sc.x0.shape[0]
        xs = torch.tensor(rng.normal(size=(dim,)) + 1j * rng.normal(size=(dim,)))
        uu = torch.tensor([0.5 * sc.sat])
        before = expm_small.launches
        card = fn(sc.plant.to(cuda, torch.float32), xs.to(cuda, torch.complex64),
                  uu.to(cuda, torch.float32), sc.config.dt, 2, 12)
        assert expm_small.launches == before + 1
        torch.testing.assert_close(card.cpu().to(torch.complex128),
                                   fn(sc.plant, xs, uu, sc.config.dt, 2, 12), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["not_state", "not_gate", "lindblad_state", "drag_state",
                                  "not_state_freq", "crosstalk", "cnot_state"])
def test_plant_steps_hand_expm_a_row_major_batch(cuda, name, monkeypatch):
    """Each fleet's plant step on the card gives expm_small a contiguous,
    unconjugated batch: the wrapper copies nothing, and a step's exponential
    is the one kernel."""
    from mpc4quantum_tpu_torch import presets
    from mpc4quantum_tpu_torch.benchfleet import expm_budget_for
    from mpc4quantum_tpu_torch.parallel.fleet import make_scenario_batch
    from mpc4quantum_tpu_torch.plants import lindblad, quantum

    seen = []

    def recorder(A, *args, **kw):
        seen.append(A.is_contiguous() and not A.is_conj())
        return expm_small(A, *args, **kw)

    monkeypatch.setattr(quantum, "expm_small", recorder)
    monkeypatch.setattr(lindblad, "expm_small", recorder)
    sc = presets.PRESETS[name]()
    plants = make_scenario_batch(sc.plant, 64, generator=torch.Generator().manual_seed(1))
    x = sc.x0.expand(64, -1).contiguous()
    u = torch.full((64, sc.U_targ.shape[0]), 0.5 * sc.sat, device=cuda)
    out = plants.step(x, u, sc.config.dt, *expm_budget_for(plants, sc.config.dt, sc.sat))
    torch.cuda.synchronize()
    assert seen == [True]
    assert bool(torch.isfinite(torch.view_as_real(out)).all())


@pytest.mark.parametrize("name", ["crosstalk", "cnot_state"])
def test_pair_presets_build_on_the_card_in_float32(cuda, name):
    from mpc4quantum_tpu_torch import presets
    from mpc4quantum_tpu_torch.benchfleet import expm_budget_for
    from mpc4quantum_tpu_torch.parallel.fleet import make_scenario_batch

    sc = presets.PRESETS[name]()
    for t in (sc.x0, sc.model.A, sc.X_targ, sc.U_targ, sc.Q, sc.R, sc.Qf, sc.target_state,
              sc.plant.H0, sc.plant.H1s, sc.plant.sigma):
        assert t.device.type == "cuda"
        assert t.dtype == (torch.complex64 if t.is_complex() else torch.float32)
    assert sc.plant.lift_kind == ("partial_trace" if name == "crosstalk" else "identity")
    plants = make_scenario_batch(sc.plant, 32)
    assert plants.device.type == "cuda" and plants.lift_kind == sc.plant.lift_kind
    assert expm_budget_for(plants, sc.config.dt, sc.sat) == (12, 0)


def test_batched_lifts_on_the_card_equal_the_cpu(cuda):
    """The partial-trace and truncate adapters on float32 card tensors
    against the float64 CPU ones; the partial-trace lift of the crosstalk
    fleet's lane batch goes through the plant."""
    from mpc4quantum_tpu_torch import presets
    from mpc4quantum_tpu_torch.parallel.fleet import make_scenario_batch
    from mpc4quantum_tpu_torch.plants import quantum

    rng = np.random.default_rng(11)
    crandn = lambda *shape: torch.tensor(rng.normal(size=shape) + 1j * rng.normal(size=shape))
    card = lambda t: t.to(cuda, torch.complex64)
    back = lambda t: t.cpu().to(torch.complex128)
    x, z = crandn(256, 16), crandn(256, 8)
    plants = make_scenario_batch(presets.crosstalk(coupling=0.05).plant, 256)
    assert plants.device.type == "cuda"
    torch.testing.assert_close(back(plants.lift(card(x))), quantum.partial_trace_lift(x),
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(back(plants.proj(card(z))), quantum.tensor_proj(z),
                               rtol=0, atol=1e-5)
    assert plants.lift(card(x)).shape == (256, 8) and plants.proj(card(z)).shape == (256, 16)
    x9, z4 = crandn(64, 9), crandn(64, 4)
    x9[:, 0] += 5.0   # keep the truncated trace away from 0
    torch.testing.assert_close(back(quantum.truncate_lift(card(x9), 3, 2)),
                               quantum.truncate_lift(x9, 3, 2), rtol=0, atol=1e-5)
    out = quantum.truncate_proj(card(z4), 3, 2)
    assert out.device.type == "cuda"
    torch.testing.assert_close(back(out), quantum.truncate_proj(z4, 3, 2), rtol=0, atol=1e-6)


def test_kernels_refuse_what_they_do_not_take(cuda):
    # the kernels take any size (as the Pallas kernels do); other dtypes and
    # shapes raise, with no fall back to the plain version
    before = expm_small.launches
    with pytest.raises(ValueError, match="complex64"):
        expm_small(torch.zeros(4, 9, 9, dtype=torch.complex128, device=cuda))
    with pytest.raises(ValueError, match="complex64"):
        expm_small(torch.zeros(4, 3, 2, dtype=torch.complex64, device=cuda))
    assert expm_small.launches == before
    P = torch.eye(17, device=cuda).expand(2, 17, 17)
    v = torch.zeros(2, 17, device=cuda)
    with pytest.raises(ValueError, match="n <= 16"):
        boxqp_small(P, v, v, v, iters=1, rounds=1)
    with pytest.raises(ValueError, match="float32"):
        boxqp_small(P[:, :4, :4].double(), v[:, :4], v[:, :4], v[:, :4], iters=1, rounds=1)
    n = 240
    K = torch.eye(n, device=cuda).expand(2, n, n).contiguous()
    w, r = torch.zeros(2, n, device=cuda), torch.ones(2, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        admm_big(K.double(), w, w, w, r, w, w, w, iters=1, sigma=1e-6, alpha=1.6)
    with pytest.raises(ValueError, match="rho"):
        admm_big(K, w, w, w, w, w, w, w, iters=1, sigma=1e-6, alpha=1.6)
    with pytest.raises(ValueError, match="contiguous"):
        admm_big(P.transpose(1, 2), v, v, v, r, v, v, v, iters=1, sigma=1e-6, alpha=1.6)


def test_solve_boxqp_on_the_card_matches_the_cpu(cuda):
    """The adaptive Cholesky box-QP on the card in float32 against float64
    on the CPU, cold at the library's 2x150; a NaN lane never converges
    and nothing raises."""
    from mpc4quantum_tpu_torch.solvers.boxqp import solve_boxqp

    P, q, lb, ub = qp_batch(512, 10, seed=9, device=cuda)
    P[3, 0, 0] = float("nan")
    card = solve_boxqp(P, q, lb, ub)
    cpu = solve_boxqp(*(t.cpu().double() for t in (P, q, lb, ub)))
    assert not bool(card.converged[3]) and bool(torch.isnan(card.x[3]).all())
    both = card.converged.cpu() & cpu.converged
    assert float(both.float().mean()) >= 0.99
    dz = ((card.x.cpu().double() - cpu.x).abs().amax(dim=1)
          / torch.clamp(cpu.x.abs().amax(dim=1), min=1.0))
    assert float(dz[both].max()) <= 1e-3


def test_cli_on_the_card(cuda, capsys):
    """`python -m mpc4quantum_tpu_torch not_state` on the card: the chol QP
    launches no QP kernel, the plant one expm_small a step."""
    import json

    from mpc4quantum_tpu_torch.__main__ import main

    before = (boxqp_small.launches, expm_small.launches)
    assert main(["not_state"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["exit_code"] == 0 and out["n_valid"] == 20 and out["fidelity"] > 0.995
    assert (boxqp_small.launches - before[0], expm_small.launches - before[1]) == (0, 20)
