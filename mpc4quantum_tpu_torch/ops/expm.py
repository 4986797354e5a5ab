"""Batched matrix exponential of small matrices (counterpart of
mpc4quantum_tpu/ops/expm.py): scaling-and-squaring with a Horner Taylor
evaluation (`expm_taylor`, matmul-only, the plain version behind the expm
kernel, kernels/expm.py) and with the Pade-13 approximant (`expm_pade`, the
reference's default, whose linear solve runs as a real LU). Also the Taylor
budget from a norm bound, and the per-step generators and propagators of a
control trajectory.
"""

from __future__ import annotations

import math

import torch

from ..utils.linalg import cx_solve

# Pade-13 numerator coefficients b0..b13, and the largest 1-norm at which
# the degree-13 approximant is exact to double precision
_PADE_B = (64764752532480000.0, 32382376266240000.0, 7771770303897600.0,
           1187353796428800.0, 129060195264000.0, 10559470521600.0, 670442572800.0,
           33522128640.0, 1323241920.0, 40840800.0, 960960.0, 16380.0, 182.0, 1.0)
_THETA_13 = 5.371920351148152


def expm_pade(A: torch.Tensor, max_squarings: int = 16) -> torch.Tensor:
    """exp(A) for A of shape (..., d, d), real or complex, by Pade-13 with
    per-matrix scaling and squaring: s = clip(ceil(log2(max(||A||_1 /
    theta_13, 1))), 0, max_squarings) squarings, applied as a masked loop
    of max_squarings steps (a norm that needs more saturates). The solve
    (V - U) R = V + U of a complex A goes through its real block embedding
    (utils.linalg.cx_solve), as the reference solves it. Plain PyTorch on
    any device: the reference computes it outside any kernel.
    """
    b = _PADE_B
    d = A.shape[-1]
    norm1 = A.abs().sum(dim=-2).amax(dim=-1)
    s = torch.ceil(torch.log2(torch.clamp(norm1 / _THETA_13, min=1.0))).clamp(0, max_squarings)
    As = A * torch.exp2(-s)[..., None, None].to(A.dtype)
    eye = torch.eye(d, dtype=A.dtype, device=A.device).expand(A.shape)
    A2 = As @ As
    A4 = A2 @ A2
    A6 = A2 @ A4
    U = As @ (A6 @ (b[13] * A6 + b[11] * A4 + b[9] * A2)
              + b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * eye)
    V = (A6 @ (b[12] * A6 + b[10] * A4 + b[8] * A2)
         + b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * eye)
    if A.is_complex():
        R = cx_solve(V - U, V + U)
    else:
        R = torch.linalg.solve(V - U, V + U)
    for i in range(max_squarings):
        R = torch.where((i < s)[..., None, None], R @ R, R)
    return R


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


def taylor_budget(bound: float) -> tuple[int, int]:
    """(taylor_k, squarings) of an exact Taylor expm for generators whose
    1-norm is at most `bound`: Horner degree 12 and the least squarings s
    with bound * 1.3 / 2^s <= 0.8 (truncation ~9e-12 at a scaled norm of
    0.8; 1.3 is a safety margin on the bound). At s = 0 the expm skips its
    norm, scaling and squaring."""
    squarings = max(0, int(math.ceil(math.log2(max(bound, 1e-12) * 1.3 / 0.8))))
    # the form certifies itself: the scaled norm is within Taylor 12's range
    assert bound * 2.0 ** -squarings <= 0.8, (bound, squarings)
    return 12, squarings


def step_generators(H0: torch.Tensor, H1s: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
    """Per-step generators H(u_t) = H0 + sum_i u_i(t) H1_i.

    :param H0: (d, d); :param H1s: (dim_u, d, d); :param us: (dim_u, n).
    :return: (n, d, d).
    """
    us = us.reshape(H1s.shape[0], -1).to(H1s.dtype)
    return H0[None] + torch.einsum("ut,udc->tdc", us, H1s)


def propagators_from_controls(H0: torch.Tensor, H1s: torch.Tensor, us: torch.Tensor, dt: float,
                              hermitian_generator: bool = True) -> torch.Tensor:
    """Per-step propagators of piecewise-constant controls, all n of them
    from one `expm_small` call (the kernel on the card, its plain version on
    the CPU) at the Taylor budget of a host-side norm bound of these
    controls (`taylor_budget`).

    :param hermitian_generator: True: H are Hamiltonians and the
        propagator is exp(-i dt H); False: H are generators already (e.g.
        Liouvillians) and it is exp(dt H).
    :return: (n, d, d).
    """
    from ..kernels.expm import expm_small
    from ..plants.base import box_norm_bound

    sat = us.reshape(H1s.shape[0], -1).abs().amax(dim=1)
    taylor_k, squarings = taylor_budget(box_norm_bound(H0, H1s, dt, sat.cpu().numpy()))
    G = step_generators(H0, H1s, us)
    G = (-1j * dt) * G if hermitian_generator else dt * G
    return expm_small(G, taylor_k=taylor_k, max_squarings=squarings)
