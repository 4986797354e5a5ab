"""Batched matrix exponential of small matrices by scaling-and-squaring with
a Horner Taylor evaluation (counterpart of mpc4quantum_tpu/ops/expm.py
`expm_taylor`). Matmul-only, batched over leading dims; it is the plain
version behind the expm kernel (kernels/expm.py).
"""

from __future__ import annotations

import torch


def expm_taylor(A: torch.Tensor, order: int = 16, max_squarings: int = 16,
                fixed_squarings: int | None = None) -> torch.Tensor:
    """exp(A) for A of shape (..., d, d), real or complex.

    :param fixed_squarings: scale by exactly 2^-fixed_squarings and square
        that many times; exact to ~1/(order+1)! while ||A||_1 <= 2^s. The
        caller bounds the norm (plants/quantum.taylor_norm_bound).
    :param max_squarings: with fixed_squarings None, each matrix takes
        s = clip(ceil(log2(max(||A||_1, 1))), 0, max_squarings) squarings,
        applied as a masked loop of max_squarings steps.
    """
    d = A.shape[-1]
    eye = torch.eye(d, dtype=A.dtype, device=A.device)
    if fixed_squarings is not None:
        As = A * (2.0 ** -fixed_squarings)
        E = eye + As / order
        for k in range(order - 1, 0, -1):
            E = eye + (As @ E) / k
        for _ in range(fixed_squarings):
            E = E @ E
        return E

    norm1 = A.abs().sum(dim=-2).amax(dim=-1)
    s = torch.ceil(torch.log2(torch.clamp(norm1, min=1.0))).clamp(0, max_squarings)
    As = A * torch.exp2(-s)[..., None, None].to(A.dtype)
    E = eye + As / order
    for k in range(order - 1, 0, -1):
        E = eye + (As @ E) / k
    for i in range(max_squarings):
        E = torch.where((i < s)[..., None, None], E @ E, E)
    return E
