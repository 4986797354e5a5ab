"""Relaxed-ADMM iterations from a precomputed K^-1, for box QPs of any size
n >= 1: the wrapper of the CUDA kernel csrc/admm_big.cu and its plain
PyTorch version.

The kernel replaces mpc4quantum_tpu/ops/pallas_qp.py::_admm_loop_kernel
(`_admm_iters_lanes` and `boxqp_pallas_big` there), which takes any n. Up
to n = 239 a lane's K^-1 sits in one block's registers (and shared
memory); above it one block a lane streams K^-1's rows from device memory
every iteration, with the rhs vector in shared memory, and above n =
STREAM_SMEM_MAX_N in a workspace in device memory that this wrapper
allocates. On a CPU tensor the wrapper runs the plain version; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..solvers.boxqp import admm_iters
from . import _build

# the largest n whose streaming instance keeps its two rhs buffers (8 n
# bytes) in shared memory; above it they sit in a workspace
# (kStreamSmemMaxN in csrc/admm_big.cu)
STREAM_SMEM_MAX_N = 29056


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


def check_admm_args(specs: dict, iters: int) -> tuple[int, int]:
    """What the kernel takes, from each argument's (shape, dtype,
    contiguous) by name (kinv, q, lb, ub, rho, x, z, y): kinv (B, n, n) of
    any n >= 1, rho (B,), the others (B, n), all contiguous float32, and
    iters >= 0. :return: (B, n). :raises ValueError: otherwise."""
    shape = tuple(specs["kinv"][0])
    if len(shape) != 3 or shape[1] != shape[2] or shape[1] < 1:
        raise ValueError(f"admm_big: kinv must be (B, n, n) with n >= 1, got {shape}")
    B, n = shape[0], shape[1]
    want = {"kinv": (B, n, n), "q": (B, n), "lb": (B, n), "ub": (B, n), "rho": (B,),
            "x": (B, n), "z": (B, n), "y": (B, n)}
    for name, expected in want.items():
        got, dtype, contiguous = specs[name]
        if tuple(got) != expected or dtype != torch.float32 or not contiguous:
            raise ValueError(f"admm_big: {name} must be contiguous float32 {expected}, "
                             f"got {dtype} {tuple(got)}" + ("" if contiguous else " strided"))
    if iters < 0:
        raise ValueError(f"admm_big: iters={iters}")
    return B, n


def admm_big(kinv, q, lb, ub, rho, x, z, y, *, iters: int, sigma: float, alpha: float):
    """`iters` relaxed ADMM steps per lane from K^-1 and rho:
    x = K^-1 (sigma x - q + rho z - y); z = clip(alpha x + (1 - alpha) z
    + y / rho, lb, ub); y += rho (alpha x + (1 - alpha) z_old - z).

    :param kinv: (B, n, n) K^-1 = (P + (sigma + rho) I)^-1, any n >= 1.
    :param q, lb, ub, x, z, y: (B, n); rho: (B,). On the card all float32
        and contiguous.
    :return: (x, z, y), each (B, n).
    """
    kw = dict(iters=iters, sigma=sigma, alpha=alpha)
    if kinv.device.type == "cpu":
        return admm_iters_ref(kinv, q, lb, ub, rho, x, z, y, **kw)
    if kinv.device.type != "cuda":
        raise ValueError(f"admm_big: unsupported device {kinv.device}")
    args = {"kinv": kinv, "q": q, "lb": lb, "ub": ub, "rho": rho, "x": x, "z": z, "y": y}
    B, n = check_admm_args({k: (t.shape, t.dtype, t.is_contiguous()) for k, t in args.items()},
                           iters)
    for name, t in args.items():
        if t.device != kinv.device:
            raise ValueError(f"admm_big: {name} is on {t.device}, kinv on {kinv.device}")
    x_out, z_out, y_out = (torch.empty((B, n), dtype=torch.float32, device=kinv.device)
                           for _ in range(3))
    ws = (torch.empty((B, 2, n), dtype=torch.float32, device=kinv.device)
          if n > STREAM_SMEM_MAX_N else None)
    lib = _build.library()
    stream = torch.cuda.current_stream(kinv.device).cuda_stream
    rc = lib.mpc4q_admm_big(kinv.data_ptr(), q.data_ptr(), lb.data_ptr(), ub.data_ptr(),
                            rho.data_ptr(), x.data_ptr(), z.data_ptr(), y.data_ptr(),
                            x_out.data_ptr(), z_out.data_ptr(), y_out.data_ptr(),
                            0 if ws is None else ws.data_ptr(), B, n, int(iters), float(sigma),
                            float(alpha), stream)
    _build.check(rc, "admm_big")
    admm_big.launches += 1
    return x_out, z_out, y_out


admm_big.launches = 0
