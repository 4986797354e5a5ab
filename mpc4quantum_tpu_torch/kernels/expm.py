"""Batched small-matrix exponential: the wrapper of the CUDA kernel
csrc/expm_small.cu and its plain PyTorch version.

The kernel replaces mpc4quantum_tpu/ops/pallas_expm.py::_expm_kernel
(`expm_pallas` there). On a CPU tensor the wrapper runs the plain version;
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..ops.expm import expm_taylor
from . import _build

# the d the kernel takes; the Pallas kernel takes any d (it recommends d <= 8)
SIZES = tuple(range(2, 9))


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


def expm_small(A: torch.Tensor, taylor_k: int = 18, max_squarings: int = 12) -> torch.Tensor:
    """exp(A) for a batch A of shape (B, d, d), complex, d from 2 to 8
    on the card (complex64; another d raises), any d on the CPU.

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
    if A.dtype != torch.complex64 or A.dim() != 3 or A.shape[1] != A.shape[2] \
            or A.shape[1] not in SIZES:
        raise ValueError(f"expm_small: A must be complex64 (B, d, d) with d in {SIZES}, "
                         f"got {A.dtype} {tuple(A.shape)}")
    if taylor_k < 1 or max_squarings < 0:
        raise ValueError(f"expm_small: taylor_k={taylor_k}, max_squarings={max_squarings}")
    B, d, _ = A.shape
    # the kernel reads the caller's row-major layout: a copy only for a
    # strided or conjugated view, or one not 16-byte aligned (the kernel
    # reads a matrix of even d as float4s)
    A = A.resolve_conj().contiguous()
    if A.data_ptr() % 16:
        A = A.clone()
    out = torch.empty((B, d, d), dtype=A.dtype, device=A.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(A.device).cuda_stream
    rc = lib.mpc4q_expm_small(A.data_ptr(), out.data_ptr(), B, d, int(taylor_k),
                              int(max_squarings), stream)
    _build.check(rc, "expm_small")
    expm_small.launches += 1
    return out


expm_small.launches = 0
