"""Control-monomial libraries and Khatri-Rao products (counterpart of
mpc4quantum_tpu/ops/library.py).

The power lists are static numpy combinatorics; lifting a control
trajectory is an unrolled chain of multiplies on tensors of any trailing
shape, so a lane batch rides along as an extra axis.
"""

from __future__ import annotations

from itertools import combinations

import numpy as np
import torch


def _multinomial_powers(n: int, k: int):
    """All exponent tuples of (x_1+...+x_k)^n via stars-and-bars."""
    for bars in combinations(range(n + k - 1), k - 1):
        elem = np.array([-1] + list(bars) + [n + k - 1])
        yield elem[1:] - elem[:-1] - 1


def control_powers(order: int, dim_u: int) -> np.ndarray:
    """Static (L, dim_u) int array of monomial exponents, constant term
    first, in the reference's reversed stars-and-bars order."""
    rows = [p[:-1][::-1] for p in _multinomial_powers(order, dim_u + 1)]
    return np.asarray(rows, dtype=np.int64).reshape(len(rows), dim_u)


def size_of_library(order: int, dim_u: int) -> int:
    """Number of monomials including the constant."""
    return control_powers(order, dim_u).shape[0]


def lift_controls(us: torch.Tensor, powers, scales=None) -> torch.Tensor:
    """Evaluate a monomial library on controls.

    :param us: (dim_u, ...) real controls; trailing axes (time, lanes) are
        carried through.
    :param powers: static (L, dim_u) integer exponents; a negative exponent
        makes the monomial 0 (the convention for symbolic derivatives).
    :param scales: optional static (L,) numbers multiplying the monomials,
        applied as host scalars (a tensor of them would be a synchronizing
        host-to-device copy at every call).
    :return: (L, ...) lifted controls.
    """
    powers = np.asarray(powers)
    cols = []
    for k, row in enumerate(powers):
        if (row < 0).any():
            cols.append(torch.zeros_like(us[0]))
            continue
        c = 1.0 if scales is None else float(scales[k])
        acc = None
        for i, p in enumerate(row):
            for _ in range(int(p)):
                acc = us[i] if acc is None else acc * us[i]
        if acc is None:
            cols.append(torch.ones_like(us[0]) if c == 1.0 else torch.full_like(us[0], c))
        else:
            cols.append(acc if c == 1.0 else acc * c)
    return torch.stack(cols, dim=0)


def diff_library_powers(order: int, dim_u: int):
    """Static data for the gradient of the non-constant monomial library:
    (dpowers (dim_u, L-1, dim_u), dcoefs (dim_u, L-1))."""
    plist = control_powers(order, dim_u)[1:]
    dpowers = np.stack([plist - np.eye(dim_u, dtype=np.int64)[i] for i in range(dim_u)])
    dcoefs = np.stack([plist[:, i] for i in range(dim_u)]).astype(np.float64)
    return dpowers, dcoefs


def diff_lift_controls(us: torch.Tensor, dpowers, dcoefs) -> torch.Tensor:
    """Monomial-library Jacobian: J[i, l, ...] = d f_l(u) / d u_i.

    :param us: (dim_u, ...) controls.
    :return: (dim_u, L-1, ...).
    """
    cols = [lift_controls(us, dpowers[i], dcoefs[i]) for i in range(us.shape[0])]
    return torch.stack(cols, dim=0)


def krtimes(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Khatri-Rao (column-wise Kronecker) product:
    (La, n), (Lb, n) -> (La*Lb, n) with out[a*Lb + b, t] = A[a, t] * B[b, t]."""
    return (A[:, None] * B[None]).reshape(-1, *A.shape[1:])
