"""Batched small box-QP solve: the wrapper of the CUDA kernel
csrc/boxqp_small.cu, its plain PyTorch version, and the acceptance rule.

The kernel replaces mpc4quantum_tpu/ops/pallas_qp.py::_qp_kernel (`boxqp_pallas`
and `boxqp_accept` there). On a CPU tensor the wrapper runs the plain
version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..solvers.boxqp import BoxQPAux, BoxQPParams, accept_rule, solve_boxqp_fixed
from . import _build

MAX_N = 16


def boxqp_small_ref(P, q, lb, ub, x0=None, y0=None, rho0=None, *, iters: int,
                    rounds: int, rho_scale: float = 0.1, sigma: float = 1e-6,
                    alpha: float = 1.6, eps_abs: float = 1e-6, eps_rel: float = 1e-6,
                    acc_abs: float = 1e-3, acc_rel: float = 1e-3):
    """Plain version of the kernel: solvers/boxqp.solve_boxqp_fixed on any
    device and dtype. :return: (z (B, n), y (B, n), BoxQPAux)."""
    params = BoxQPParams(rho0=rho_scale, sigma=sigma, alpha=alpha, eps_abs=eps_abs,
                         eps_rel=eps_rel, max_iter=iters, n_rounds=rounds,
                         accept_abs=acc_abs, accept_rel=acc_rel)
    return solve_boxqp_fixed(P, q, lb, ub, x0=x0, y0=y0, rho0=rho0, params=params)


def boxqp_small(P, q, lb, ub, x0=None, y0=None, rho0=None, *, iters: int, rounds: int,
                rho_scale: float = 0.1, sigma: float = 1e-6, alpha: float = 1.6,
                eps_abs: float = 1e-6, eps_rel: float = 1e-6, acc_abs: float = 1e-3,
                acc_rel: float = 1e-3, scale: bool = False):
    """Solve B independent box QPs  min 1/2 x^T P x + q^T x, lb <= x <= ub.

    :param P: (B, n, n), n <= 16; q, lb, ub: (B, n).
    :param x0: optional (B, n) warm start; y0: optional (B, n) dual warm
        start (None = zeros); rho0: optional (B,) penalty warm start, lanes
        <= 0 take the cold default rho_scale * mean(diag P).
    :param iters, rounds: ADMM steps per round and rounds with a rho
        rebalance between them.
    :return: (z (B, n) box-feasible solution, y (B, n) final dual,
        BoxQPAux of (B,) residual statistics and the final rho).
    """
    if scale:
        raise NotImplementedError("the Jacobi-scaled box-QP kernel is not ported")
    kw = dict(iters=iters, rounds=rounds, rho_scale=rho_scale, sigma=sigma, alpha=alpha,
              eps_abs=eps_abs, eps_rel=eps_rel, acc_abs=acc_abs, acc_rel=acc_rel)
    if P.device.type == "cpu":
        return boxqp_small_ref(P, q, lb, ub, x0, y0, rho0, **kw)
    if P.device.type != "cuda":
        raise ValueError(f"boxqp_small: unsupported device {P.device}")
    B, n, n2 = P.shape
    if n != n2 or not 1 <= n <= MAX_N:
        raise ValueError(f"boxqp_small: P must be (B, n, n) with n <= {MAX_N}, got {tuple(P.shape)}")

    def soa(t, shape, name):
        if t.device != P.device or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"boxqp_small: {name} must be float32 {shape} on {P.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        return t.reshape(shape[0], -1).T.contiguous()

    Ps = soa(0.5 * (P + P.transpose(1, 2)), (B, n, n), "P")
    q_, lb_, ub_ = (soa(t, (B, n), name) for t, name in ((q, "q"), (lb, "lb"), (ub, "ub")))
    zeros = torch.zeros((n, B), dtype=torch.float32, device=P.device)
    x0_ = zeros if x0 is None else soa(x0, (B, n), "x0")
    y0_ = zeros if y0 is None else soa(y0, (B, n), "y0")
    rho0_ = (torch.zeros(B, dtype=torch.float32, device=P.device) if rho0 is None
             else soa(rho0, (B,), "rho0").reshape(B))
    z = torch.empty((n, B), dtype=torch.float32, device=P.device)
    y = torch.empty((n, B), dtype=torch.float32, device=P.device)
    aux = torch.empty((len(BoxQPAux._fields), B), dtype=torch.float32, device=P.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(P.device).cuda_stream
    rc = lib.mpc4q_boxqp_small(
        Ps.data_ptr(), q_.data_ptr(), lb_.data_ptr(), ub_.data_ptr(), x0_.data_ptr(),
        y0_.data_ptr(), rho0_.data_ptr(), z.data_ptr(), y.data_ptr(), aux.data_ptr(),
        B, n, int(iters), int(rounds), rho_scale, sigma, alpha, eps_abs, eps_rel,
        acc_abs, acc_rel, stream)
    _build.check(rc, "boxqp_small")
    boxqp_small.launches += 1
    return z.T, y.T, BoxQPAux(*aux.unbind(0))


boxqp_small.launches = 0


def boxqp_accept(aux: BoxQPAux, eps_abs: float, eps_rel: float,
                 accept_abs: float, accept_rel: float) -> torch.Tensor:
    """The solver's acceptance rule on a solve's statistics: (B,) bool."""
    return accept_rule(*aux[:7], eps_abs, eps_rel, accept_abs, accept_rel)
