"""Relaxed-ADMM iterations from a precomputed K^-1, for box QPs of any size
n >= 1: the wrapper of the CUDA kernel csrc/admm_big.cu, its launch plan
and its plain PyTorch version.

The kernel replaces mpc4quantum_tpu/ops/pallas_qp.py::_admm_loop_kernel
(`_admm_iters_lanes` and `boxqp_pallas_big` there), which takes any n. The
instance depends on n alone (`admm_big_plan`):
- n <= 239: one block a lane, each thread's part of a K^-1 row in
  registers (and, above n 160, the rest of it in shared memory);
- 240 <= n <= CLUSTER_MAX_N: one thread-block cluster of c CTAs a lane (c
  the least in 2..16 that fits: 2 at n 240-416, 8 at n 673-736, 10 at
  cnot_h250's n 750, 16 at 1008; above 8 a non-portable size), CTA k
  holding rows [k R, k R + R) of K^-1 for the whole launch, two rows a
  thread, 40 columns of each row part in registers and the rest in shared
  memory; each iteration's rhs vector goes to every CTA by st.async,
  counted on each CTA's mbarrier, with no cluster-wide barrier in the
  loop, so K^-1 is read from device memory once a launch. It is bound by
  each iteration's serial chain;
- above: a cluster of STREAM_CLUSTER CTAs a lane, each streaming its rows
  of K^-1 from L2 or device memory every iteration, the rhs vector
  exchanged as in the cluster instance ("stream"), and above n =
  STREAM_SMEM_MAX_N kept in a workspace in device memory that this wrapper
  allocates, with a cluster barrier an iteration ("stream_ws").
On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..solvers.boxqp import admm_iters
from . import _build

# the largest n of the register instances and of the cluster instance
# (kMaxN, kClusterMaxN in csrc/admm_big.cu)
REG_MAX_N = 239
CLUSTER_MAX_N = 1008
# the largest n whose streaming instance keeps its two rhs buffers (8 n
# bytes) and their mbarriers in shared memory; above it they sit in a
# workspace (kStreamSmemMaxN)
STREAM_SMEM_MAX_N = 29054
# the instances in the order of mpc4q_admm_big_plan's ids: the register
# instances by their largest n, the cluster, the streaming instance with
# its rhs in shared memory and on the workspace
INSTANCES = ("reg32", "reg64", "reg128", "reg160", "reg239", "cluster", "stream", "stream_ws")
# a register instance: (largest n, register columns C, parts S, lanes a
# block, part of each row in shared memory)
_REG_FORMS = ((32, 32, 1, 4, False), (64, 64, 1, 1, False), (128, 64, 2, 1, False),
              (160, 40, 4, 1, False), (REG_MAX_N, 32, 4, 1, True))
# the cluster instance's register columns and parts a row, rows a thread,
# its largest cluster (above the portable 8: a non-portable size), a CTA's
# most threads and shared bytes
_CLUSTER_C, _CLUSTER_S, _CLUSTER_ROWS, MAX_CLUSTER = 40, 4, 2, 16
_CLUSTER_THREADS, MAX_SMEM = 512, 232448
# the streaming instances: CTAs a lane and threads a CTA (kStreamCluster,
# kStreamThreads)
STREAM_CLUSTER, _STREAM_THREADS = 16, 512


class Plan(NamedTuple):
    """How a call runs: the instance, its cluster size (1 outside the
    cluster instance), threads a block and dynamic shared bytes a block."""
    instance: str
    cluster: int
    threads: int
    smem: int


def _part_len(n: int, S: int) -> int:
    return ((n + S - 1) // S + 3) // 4 * 4


def _part_stride(L: int, C: int) -> int:
    m = max(L, C)
    return m if (m // 4) % 2 else m + 4


def _cluster_fit(n: int):
    """(c, threads, shared bytes) of the least cluster in 2..16 whose CTA
    fits n, or None (cluster_plan in csrc/admm_big.cu)."""
    L = _part_len(n, _CLUSTER_S)
    PL = _part_stride(L, _CLUSTER_C)
    for c in range(2, MAX_CLUSTER + 1):
        T = (-(-(-(-n // c)) // _CLUSTER_ROWS) * _CLUSTER_S + 31) // 32 * 32
        smem = 16 + 4 * (T * _CLUSTER_ROWS * (L - _CLUSTER_C + 3) + 2 * _CLUSTER_S * PL)
        if T <= _CLUSTER_THREADS and smem <= MAX_SMEM:
            return c, T, smem
    return None


def admm_big_plan(B: int, n: int) -> Plan:
    """The launch plan of an `admm_big` call at batch B and size n, as the
    kernel library computes it (mpc4q_admm_big_plan): the instance by n
    alone, and its cluster size, threads and shared bytes a block."""
    if B < 1 or n < 1:
        raise ValueError(f"admm_big_plan: B={B}, n={n}")
    for k, (nmax, C, S, lanes, tail) in enumerate(_REG_FORMS):
        if n <= nmax:
            # a lane's region: the two rhs buffers, or a warp lane's staged
            # K^-1 (rows of odd stride n | 1) where that is larger
            L, T = _part_len(n, S), 32 if lanes > 1 else (n * S + 31) // 32 * 32
            vec = S * _part_stride(L, C)
            region = n * (n | 1) if lanes > 1 and n * (n | 1) > 2 * vec else 2 * vec
            return Plan(INSTANCES[k], 1, T * lanes,
                        4 * (lanes * ((region + 3) // 4 * 4) + ((L - C) * T if tail else 0)))
    if n <= CLUSTER_MAX_N:
        return Plan("cluster", *_cluster_fit(n))
    if n <= STREAM_SMEM_MAX_N:
        return Plan("stream", STREAM_CLUSTER, _STREAM_THREADS, 16 + 8 * n)
    return Plan("stream_ws", STREAM_CLUSTER, _STREAM_THREADS, 0)


def admm_big_work(B: int, n: int, iters: int):
    """The work of one `admm_big` call, counted from its shapes (FMA = 2
    flops): per lane iters (2n^2 + 8n) flops and 4 (n^2 + 9n + 1) bytes -
    K^-1, q, lb, ub, x, z, y and rho read once, x, z and y written once,
    whatever the instance (the streaming ones read K^-1 every iteration:
    `stream_bytes`).

    :return: (flops, bytes).
    """
    return B * iters * (2 * n * n + 8 * n), 4 * B * (n * n + 9 * n + 1)


def stream_bytes(B: int, n: int, iters: int) -> int:
    """The bytes a streaming instance moves for one call: K^-1 read every
    iteration, the vectors once (its own bytes bound, beside the function's
    `admm_big_work`)."""
    return 4 * B * (iters * n * n + 9 * n + 1)


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
