"""Relaxed-ADMM iterations from a precomputed K^-1, for box QPs of any size
up to MAX_N: the wrapper of the CUDA kernel csrc/admm_big.cu and its plain
PyTorch version.

The kernel replaces mpc4quantum_tpu/ops/pallas_qp.py::_admm_loop_kernel
(`_admm_iters_lanes` and `boxqp_pallas_big` there). On a CPU tensor the
wrapper runs the plain version; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from ..solvers.boxqp import admm_iters
from . import _build

# the largest n the kernel takes (cnot_state's n = 150 is the largest preset)
MAX_N = 239


def admm_big_work(B: int, n: int, iters: int):
    """The work of one `admm_big` call, counted from its shapes (FMA = 2
    flops): per lane iters (2n^2 + 8n) flops and 4 (n^2 + 9n + 1) bytes -
    K^-1, q, lb, ub, x, z, y and rho read once, x, z and y written once.

    :return: (flops, bytes).
    """
    return B * iters * (2 * n * n + 8 * n), 4 * B * (n * n + 9 * n + 1)


def admm_iters_ref(kinv, q, lb, ub, rho, x, z, y, *, iters: int, sigma: float,
                   alpha: float):
    """Plain version of the kernel: solvers/boxqp.admm_iters on any device
    and dtype. :return: (x, z, y), each (B, n)."""
    return admm_iters(kinv, q, lb, ub, rho, x, z, y, iters=iters, sigma=sigma, alpha=alpha)


def admm_big(kinv, q, lb, ub, rho, x, z, y, *, iters: int, sigma: float, alpha: float):
    """`iters` relaxed ADMM steps per lane from K^-1 and rho:
    x = K^-1 (sigma x - q + rho z - y); z = clip(alpha x + (1 - alpha) z
    + y / rho, lb, ub); y += rho (alpha x + (1 - alpha) z_old - z).

    :param kinv: (B, n, n) K^-1 = (P + (sigma + rho) I)^-1, n <= MAX_N.
    :param q, lb, ub, x, z, y: (B, n); rho: (B,). On the card all float32
        and contiguous.
    :return: (x, z, y), each (B, n).
    """
    kw = dict(iters=iters, sigma=sigma, alpha=alpha)
    if kinv.device.type == "cpu":
        return admm_iters_ref(kinv, q, lb, ub, rho, x, z, y, **kw)
    if kinv.device.type != "cuda":
        raise ValueError(f"admm_big: unsupported device {kinv.device}")
    B, n, n2 = kinv.shape
    if n != n2 or not 1 <= n <= MAX_N:
        raise ValueError(f"admm_big: kinv must be (B, n, n) with n <= {MAX_N}, "
                         f"got {tuple(kinv.shape)}")
    for name, t, shape in (("kinv", kinv, (B, n, n)), ("q", q, (B, n)), ("lb", lb, (B, n)),
                           ("ub", ub, (B, n)), ("rho", rho, (B,)), ("x", x, (B, n)),
                           ("z", z, (B, n)), ("y", y, (B, n))):
        if (t.device != kinv.device or t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"admm_big: {name} must be contiguous float32 {shape} on "
                             f"{kinv.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if iters < 0:
        raise ValueError(f"admm_big: iters={iters}")
    x_out, z_out, y_out = (torch.empty((B, n), dtype=torch.float32, device=kinv.device)
                           for _ in range(3))
    lib = _build.library()
    stream = torch.cuda.current_stream(kinv.device).cuda_stream
    rc = lib.mpc4q_admm_big(kinv.data_ptr(), q.data_ptr(), lb.data_ptr(), ub.data_ptr(),
                            rho.data_ptr(), x.data_ptr(), z.data_ptr(), y.data_ptr(),
                            x_out.data_ptr(), z_out.data_ptr(), y_out.data_ptr(),
                            B, n, int(iters), float(sigma), float(alpha), stream)
    _build.check(rc, "admm_big")
    admm_big.launches += 1
    return x_out, z_out, y_out


admm_big.launches = 0
