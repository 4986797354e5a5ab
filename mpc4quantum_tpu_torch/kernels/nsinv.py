"""The cold Newton-Schulz K^-1 of the large-n box QP: the wrapper of the
CUDA kernel csrc/ns_cold.cu and its plain PyTorch version.

`ns_cold(K, iters)` is solvers/boxqp.ns_inverse(K, iters) with no warm
start: the cold init K^T / (||K||_1 ||K||_inf), iters - 1 float32 steps
and the last step with its residual in float64. The kernel runs a lane's
whole chain in one CTA, its operands in shared memory. It replaces no
Pallas kernel; the JAX package leaves this chain to XLA's matmuls.
kernels/boxqp.boxqp_big hands it to solve_boxqp_fixed, which takes it for
a cold chain on what `fits` (float32 on the card, MIN_N <= n <= MAX_N);
every other K^-1 keeps the plain chain. On a CPU tensor the wrapper runs
the plain version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..solvers.boxqp import _ns_inverse
from . import _build

# the kernel's sizes (kMinN, kMaxN in csrc/ns_cold.cu): below MIN_N the QP is
# boxqp_small's; at MAX_N a lane's X and I - K X fill a CTA's shared memory
MIN_N = 17
MAX_N = 152


def fits(K: torch.Tensor) -> bool:
    """Whether the kernel takes K: a float32 (B, n, n) batch on the card,
    MIN_N <= n <= MAX_N."""
    return (K.device.type == "cuda" and K.dtype == torch.float32 and K.dim() == 3
            and K.shape[-1] == K.shape[-2] and MIN_N <= K.shape[-1] <= MAX_N)


def ns_cold(K: torch.Tensor, iters: int) -> torch.Tensor:
    """The cold Newton-Schulz inverse of `iters` steps of each K (B, n, n),
    in one launch on the card.

    :return: X (B, n, n) in K's dtype.
    """
    if K.device.type == "cpu":
        return _ns_inverse(K, iters)[0]
    if K.device.type != "cuda":
        raise ValueError(f"ns_cold: unsupported device {K.device}")
    if not fits(K):
        raise ValueError(f"ns_cold: K must be float32 (B, n, n) with {MIN_N} <= n <= "
                         f"{MAX_N}, got {K.dtype} {tuple(K.shape)}")
    if iters < 0:
        raise ValueError(f"ns_cold: iters={iters}")
    K = K.contiguous()
    X = torch.empty_like(K)
    B, n = K.shape[0], K.shape[-1]
    if B:
        stream = torch.cuda.current_stream(K.device).cuda_stream
        _build.check(_build.library().mpc4q_ns_cold(K.data_ptr(), X.data_ptr(), B, n,
                                                  int(iters), stream), "ns_cold")
        ns_cold.launches += 1
    return X


ns_cold.launches = 0
ns_cold.fits = fits
