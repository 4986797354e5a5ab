"""Small linear-algebra helpers (counterpart of mpc4quantum_tpu/utils/linalg.py)."""

from __future__ import annotations

import torch


def cx_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matmul that accepts one real and one complex operand.

    `torch.matmul` refuses mixed real/complex operands; the complex side is
    split into two real products instead of casting the real side up, which
    costs half the FLOPs of a complex product.
    """
    if a.is_complex() and not b.is_complex():
        return torch.complex(a.real @ b, a.imag @ b)
    if b.is_complex() and not a.is_complex():
        return torch.complex(a @ b.real, a @ b.imag)
    return a @ b


def complex_to_real_op(P: torch.Tensor) -> torch.Tensor:
    """Complex operator (..., m, n) -> its real block embedding
    [[Re, -Im], [Im, Re]] (..., 2m, 2n); a real operator embeds as
    [[P, 0], [0, P]]."""
    P = torch.as_tensor(P)
    re, im = P.real, (P.imag if P.is_complex() else torch.zeros_like(P))
    return torch.cat([torch.cat([re, -im], dim=-1), torch.cat([im, re], dim=-1)], dim=-2)


def cx_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched solve A X = B for complex A through the real block embedding
    [[Re, -Im], [Im, Re]] and one real LU, as the reference solves it. A
    singular system gives NaN (torch.linalg.solve would raise for the
    whole batch)."""
    d = A.shape[-1]
    Ar = torch.cat([torch.cat([A.real, -A.imag], dim=-1),
                    torch.cat([A.imag, A.real], dim=-1)], dim=-2)
    B = B.to(A.dtype)
    X, info = torch.linalg.solve_ex(Ar, torch.cat([B.real, B.imag], dim=-2))
    X = torch.where((info == 0).reshape(info.shape + (1, 1)), X, float("nan"))
    return torch.complex(X[..., :d, :], X[..., d:, :])


def gj_inverse(K: torch.Tensor) -> torch.Tensor:
    """Inverse of a batched (..., n, n) matrix by unpivoted Gauss-Jordan in
    matrix form: n column-elimination steps of whole-tensor elementwise ops.

    This is the exact elimination order of the box-QP kernel
    (csrc/boxqp_small.cu), so the plain QP solver follows the kernel's
    iterates. K = P + (sigma + rho) I is SPD with a rho shift, which keeps
    the pivot-free elimination stable.
    """
    n = K.shape[-1]
    if n == 1:
        return 1.0 / K
    inv = torch.eye(n, dtype=K.dtype, device=K.device).expand(K.shape)
    rows = torch.arange(n, device=K.device)[:, None]
    for col in range(n):
        rowmask = rows == col
        piv = 1.0 / K[..., col:col + 1, col:col + 1]
        prow_K = K[..., col:col + 1, :] * piv
        prow_I = inv[..., col:col + 1, :] * piv
        fac = K[..., :, col:col + 1]
        K = torch.where(rowmask, prow_K, K - fac * prow_K)
        inv = torch.where(rowmask, prow_I, inv - fac * prow_I)
    return inv


def pinv(a: torch.Tensor, rtol=None) -> torch.Tensor:
    """Moore-Penrose pseudo-inverse of (..., m, n) by SVD, cut as
    `jnp.linalg.pinv` cuts it: singular values s <= rtol * s_max count as
    zero (strictly greater ones are inverted), rtol defaulting to
    10 max(m, n) eps of the dtype. (`torch.linalg.pinv` keeps s equal to
    the cutoff, and its default rtol is a tenth of this one.)

    :param rtol: a float, or a (...,) tensor of per-matrix cutoffs.
    A matrix with a non-finite entry gives NaN (as in the reference),
    where `torch.linalg.svd` would raise for the whole batch.
    """
    m, n = a.shape[-2:]
    if rtol is None:
        rtol = 10.0 * max(m, n) * torch.finfo(a.dtype).eps
    bad = ~torch.isfinite(a).all(dim=-1).all(dim=-1)[..., None, None]
    U, s, Vh = torch.linalg.svd(torch.where(bad, 0.0, a), full_matrices=False)
    rtol = torch.as_tensor(rtol, dtype=s.dtype, device=s.device)
    cutoff = rtol[..., None] * s[..., :1]
    s_inv = torch.where(s > cutoff, 1.0 / s, torch.zeros_like(s)).to(a.dtype)
    return torch.where(bad, float("nan"), Vh.mH @ (s_inv[..., :, None] * U.mH))
