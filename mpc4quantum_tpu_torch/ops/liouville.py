"""Liouville-space lifting and bilinear discretization (counterpart of
mpc4quantum_tpu/ops/liouville.py).

`drho/dt = -i[H0 + sum_i u_i H1_i, rho]` projected onto a measurement basis
gives `dx/dt = (A0 + sum_i u_i A_i) x`; the order-k Dyson/Taylor expansion
of one step then gives the discrete model `x+ = [A | N] [x ; f(u) (kr) x]`.
The Lindblad generators add the dissipators of an open system to A0 on
row-major vec(rho). All run once at scenario build, in complex128 by
default.
"""

from __future__ import annotations

import math
from itertools import product as iproduct

import torch

from .library import control_powers


def vectorize_me(H, measure_list, dtype=torch.complex128) -> torch.Tensor:
    """Liouville generator A[j, k] = -i tr(sigma_j^dag [H, sigma_k]) on an
    orthonormal basis.

    This is the true commutator dynamics, with the sign fix the JAX package
    documents: the reference's conjugated structure constants give
    -conj(A), which flips the response to imaginary Hamiltonian terms.

    :param H: (d, d) Hamiltonian; :param measure_list: m basis operators.
    :return: (m, m) complex generator.
    """
    basis = torch.stack([torch.as_tensor(s, dtype=dtype) for s in measure_list])
    H = torch.as_tensor(H, dtype=dtype)
    comm = torch.einsum("ab,kbc->kac", H, basis) - torch.einsum("kab,bc->kac", basis, H)
    return -1j * torch.einsum("jab,kab->jk", basis.conj(), comm)


def liouville_generator(H, dtype=torch.complex128) -> torch.Tensor:
    """-i[H, .] on row-major vec(rho): A = -i (H (x) I - I (x) H^T), the
    matrix-unit `vectorize_me` in O(d^2)."""
    H = torch.as_tensor(H, dtype=dtype)
    eye = torch.eye(H.shape[0], dtype=dtype)
    return -1j * (torch.kron(H, eye) - torch.kron(eye, H.T.contiguous()))


def dissipator(L, dtype=torch.complex128) -> torch.Tensor:
    """D[L] rho = L rho L^dag - 1/2 {L^dag L, rho} on row-major vec(rho):
    L (x) conj(L) - 1/2 ((L^dag L) (x) I + I (x) (L^dag L)^T)."""
    L = torch.as_tensor(L, dtype=dtype)
    eye = torch.eye(L.shape[0], dtype=dtype)
    LdL = L.conj().T @ L
    return torch.kron(L, L.conj()) - 0.5 * (torch.kron(LdL, eye)
                                            + torch.kron(eye, LdL.T.contiguous()))


def lindblad_generator(H, c_ops=(), dtype=torch.complex128) -> torch.Tensor:
    """The Lindbladian -i(H (x) I - I (x) H^T) + sum_k D[L_k] (row-major vec)."""
    A = liouville_generator(H, dtype)
    for L in c_ops:
        A = A + dissipator(L, dtype)
    return A


def discretize_homogeneous(A_cts_list, dt, order: int,
                           dtype=torch.complex128) -> torch.Tensor:
    """Order-k Dyson/Taylor discretization of bilinear dynamics.

    Every operator product of length <= order is binned by its control
    monomial signature; the bins are hstacked in `control_powers` order.

    :return: (dim_x, dim_x * L) with L = size_of_library(order, dim_u).
    """
    A_ops = [torch.as_tensor(A, dtype=dtype) for A in A_cts_list]
    dim_x = A_ops[0].shape[0]
    dim_u = len(A_ops) - 1
    powers_list = control_powers(order, dim_u)
    bin_index = {tuple(row): i for i, row in enumerate(powers_list)}
    bins = [torch.zeros((dim_x, dim_x), dtype=dtype) for _ in range(len(powers_list))]
    for an_order in range(order + 1):
        prefactor = (dt ** an_order) / math.factorial(an_order)
        for a_product in iproduct(range(len(A_ops)), repeat=an_order):
            entry = torch.eye(dim_x, dtype=dtype)
            for i_op in a_product:
                entry = entry @ A_ops[i_op]
            sig = [0] * dim_u
            for i_op in a_product:
                if i_op > 0:
                    sig[i_op - 1] += 1
            key = tuple(sig)
            if key not in bin_index:
                raise ValueError(
                    "Discretization error: control powers should contribute uniquely.")
            bins[bin_index[key]] = bins[bin_index[key]] + prefactor * entry
    return torch.hstack(bins)
