"""Batched small-matrix exponential: the wrapper of the CUDA kernel
csrc/expm_small.cu and its plain PyTorch version.

The kernel replaces mpc4quantum_tpu/ops/pallas_expm.py::_expm_kernel
(`expm_pallas` there) and takes what that kernel takes: any d, complex
or real input. At d 2-8 a team of threads a matrix holds X in registers; at d = 1
and d >= 9 one thread block a matrix keeps X and the Horner iterate in
shared memory, and above d = SMEM_MAX_D in a workspace in device memory
that this wrapper allocates (csrc/expm_small.cu). A real float32 batch is
run as complex64 and its real part returned, which is exact: the
exponential of a real matrix is real. On a CPU tensor the wrapper runs the
plain version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..ops.expm import expm_taylor
from . import _build

# the largest d whose block keeps X and two Horner buffers (3 x 8 d^2
# bytes) in shared memory; above it they sit in a workspace (kSmemMaxD in
# csrc/expm_small.cu)
SMEM_MAX_D = 97


def expm_small_work(B: int, d: int, taylor_k: int, squarings: int = 0):
    """The work of one `expm_small` call, counted from its shapes: per
    matrix taylor_k (8d^3 + 2d^2) flops of Horner Taylor (a complex FMA is 8
    flops) and 16 d^2 bytes (complex64 in and out), plus 8d^3 flops for
    each of the `squarings` the call's matrices take in all (0 at
    max_squarings = 0). The norm and the scaling are not counted. It counts
    the function's work, not the kernel's design: the team's threads each
    reading all of X, and the shuffles of a squaring, add nothing to it.

    :return: (flops, bytes).
    """
    return B * taylor_k * (8 * d ** 3 + 2 * d * d) + squarings * 8 * d ** 3, 16 * d * d * B


def expm_small_ref(A: torch.Tensor, taylor_k: int = 18, max_squarings: int = 12) -> torch.Tensor:
    """Plain version of the kernel: ops/expm.expm_taylor in the same form -
    no scaling or squaring at max_squarings = 0, else per-matrix squarings up
    to max_squarings.

    :raises ValueError: at max_squarings = 0 when some ||A||_1 > 1, which
        breaks the caller's certificate (the kernel does not check it).
    """
    if max_squarings == 0 and bool((A.abs().sum(dim=-2).amax(dim=-1) > 1.0).any()):
        raise ValueError("expm_small: max_squarings = 0 needs ||A||_1 <= 1 for every matrix")
    return expm_taylor(A, order=taylor_k, max_squarings=max_squarings,
                       fixed_squarings=0 if max_squarings == 0 else None)


def check_expm_args(shape, dtype, taylor_k: int, max_squarings: int) -> tuple[int, int]:
    """What the kernel takes, from the call's shape, dtype and budget: a
    batch (B, d, d) of any d >= 1 in complex64 or float32, taylor_k >= 1,
    max_squarings >= 0. :return: (B, d). :raises ValueError: otherwise."""
    if (dtype not in (torch.complex64, torch.float32) or len(shape) != 3
            or shape[1] != shape[2] or shape[1] < 1):
        raise ValueError(f"expm_small: A must be complex64 or float32 (B, d, d) with d >= 1, "
                         f"got {dtype} {tuple(shape)}")
    if taylor_k < 1 or max_squarings < 0:
        raise ValueError(f"expm_small: taylor_k={taylor_k}, max_squarings={max_squarings}")
    return int(shape[0]), int(shape[1])


def expm_small(A: torch.Tensor, taylor_k: int = 18, max_squarings: int = 12) -> torch.Tensor:
    """exp(A) for a batch A of shape (B, d, d), any d: complex64 or real
    float32 on the card (a real batch comes back real), any dtype on the CPU.

    :param taylor_k: Horner Taylor degree; 18 ~ 1e-15 truncation at
        ||A/2^s||_1 <= 1, 12 ~ 9e-12 at <= 0.8.
    :param max_squarings: bound on the per-matrix squaring count; 0 = the
        caller certifies ||A||_1 <= 1 and the kernel skips the norm, the
        scaling and the squaring.
    """
    if A.device.type == "cpu":
        return expm_small_ref(A, taylor_k, max_squarings)
    if A.device.type != "cuda":
        raise ValueError(f"expm_small: unsupported device {A.device}")
    B, d = check_expm_args(A.shape, A.dtype, taylor_k, max_squarings)
    real = A.dtype == torch.float32
    # the kernel reads the caller's row-major layout: a copy only for a
    # strided or conjugated view, or one not 16-byte aligned (the kernel
    # reads a matrix of even d as float4s), and for real input
    A = (A.to(torch.complex64) if real else A.resolve_conj()).contiguous()
    if A.data_ptr() % 16:
        A = A.clone()
    out = torch.empty((B, d, d), dtype=torch.complex64, device=A.device)
    ws = (torch.empty((B, 3, d, d), dtype=torch.complex64, device=A.device)
          if d > SMEM_MAX_D else None)
    lib = _build.library()
    stream = torch.cuda.current_stream(A.device).cuda_stream
    rc = lib.mpc4q_expm_small(A.data_ptr(), out.data_ptr(), 0 if ws is None else ws.data_ptr(),
                              B, d, int(taylor_k), int(max_squarings), stream)
    _build.check(rc, "expm_small")
    expm_small.launches += 1
    return out.real.contiguous() if real else out


expm_small.launches = 0
