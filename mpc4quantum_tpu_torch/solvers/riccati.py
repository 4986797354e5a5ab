"""Exact condensed-Hessian inverse by an LQR / Riccati factorization
(counterpart of mpc4quantum_tpu/solvers/riccati.py), batched over lanes.

The fixed-budget ADMM (solvers/boxqp.solve_boxqp_fixed, kernels/boxqp.boxqp_big)
needs K^-1 with K = P + (sigma + rho) I, P the condensed horizon Hessian
Re(M^H Qbar M) + Rbar. K is also the condensed Hessian of the
equality-constrained LQR problem over the same LTV dynamics,

    min_U  sum_{t=0}^{H} x_t^T Qr_t x_t + sum_{t=0}^{H-1} u_t^T Rr_t u_t
    s.t.   x_{t+1} = Ar_t x_t + Br_t u_t,   x_0 = 0,

in the real embedding (m = 2 dim_x; Rr_t carries the (sigma + rho) shift and
any Jacobi scaling). Column j of K^-1 is that problem's solution for the
linear cost -2 e_j^T U, so one backward Riccati pass plus one affine
backward / forward pass over all n basis columns at once gives the exact
inverse in O(H m^2 (m + n)) work, against the O(ns_iters n^3) of a
Newton-Schulz chain.

Every function takes leading batch axes on its operands and broadcasts
them (a lane batch: Ar (B, H, m, m), Br (B, H, m, du), shared costs
Qr (H+1, m, m), Rr (H, du, du)). The horizon passes are Python loops over
H (`riccati_kinv`) or log-depth associative scans (`riccati_kinv_pscan`).
The small inverses are the unpivoted Gauss-Jordan of utils/linalg.py: the
Huu blocks are SPD with the rho shift, and the scan's (I + C1 J2) has its
spectrum in [1, inf).
"""

from __future__ import annotations

import torch

from ..utils.linalg import gj_inverse

KINV_RICCATI = ("riccati", "riccati_pscan")


def _T(M: torch.Tensor) -> torch.Tensor:
    return M.transpose(-1, -2)


def _sym(M: torch.Tensor) -> torch.Tensor:
    return 0.5 * (M + _T(M))


def _embed(M: torch.Tensor, vector_blocks: bool = False) -> torch.Tensor:
    """[[Re, -Im], [Im, Re]] of a complex (..., r, c) operator, or [Re; Im]
    with vector_blocks (a complex map from real controls)."""
    if vector_blocks:
        return torch.cat([M.real, M.imag], dim=-2)
    return torch.cat([torch.cat([M.real, -M.imag], dim=-1),
                      torch.cat([M.imag, M.real], dim=-1)], dim=-2)


def embed_ltv(A_s: torch.Tensor, B_s: torch.Tensor):
    """Real-embed per-step LTV dynamics of complex states and real controls:
    x+ = A x + B u becomes the recursion of [Re x; Im x] with
    Ar = [[Re A, -Im A], [Im A, Re A]], Br = [Re B; Im B]. Real inputs pass
    through (Br takes the real part).

    :param A_s: (..., H, dx, dx); :param B_s: (..., H, dx, du).
    :return: (Ar (..., H, m, m), Br (..., H, m, du)), m = 2 dx (dx if real).
    """
    if not A_s.is_complex():
        return A_s, B_s.real
    return _embed(A_s), _embed(B_s, vector_blocks=True)


def embed_costs(Q_s: torch.Tensor, R_s: torch.Tensor):
    """Real-embed the per-step costs: Re(x^H Q x) of a Hermitian Q is the
    form of Qr = [[Re Q, -Im Q], [Im Q, Re Q]], symmetrized; R acts on real
    controls, so only its symmetrized real part enters (the part the
    condensed P holds).

    :param Q_s: (..., H+1, dx, dx); :param R_s: (..., H, du, du).
    :return: (Qr (..., H+1, m, m), Rr (..., H, du, du)) real symmetric.
    """
    Rr = _sym(R_s.real)
    Qr = _embed(Q_s) if Q_s.is_complex() else Q_s
    return _sym(Qr), Rr


def _basis(H: int, du: int, like: torch.Tensor) -> torch.Tensor:
    """W (H, du, n): W[t] is the t-th du-row block of I_n, n = H du."""
    n = H * du
    return torch.eye(n, dtype=like.dtype, device=like.device).reshape(H, du, n)


def _lead(*tensors_and_ranks) -> torch.Size:
    """The broadcast batch shape of operands given with their own ranks."""
    return torch.broadcast_shapes(*(t.shape[:t.dim() - r] for t, r in tensors_and_ranks))


def riccati_kinv(Ar, Br, Qr, Rr) -> torch.Tensor:
    """inv(Rbar + Mu^T Qbar Mu): the exact inverse of the condensed Hessian
    of (Ar, Br, Qr, Rr), where Rr already holds every diagonal shift.
    One backward Riccati pass over the horizon carrying all n affine
    columns, then one forward pass.

    :param Ar: (..., H, m, m); :param Br: (..., H, m, du);
    :param Qr: (..., H+1, m, m) symmetric PSD, terminal at H;
    :param Rr: (..., H, du, du) SPD.
    :return: (..., n, n), n = H du, rows time-major like vec(U).
    """
    H, m, du = Br.shape[-3:]
    n = H * du
    lead = _lead((Ar, 3), (Br, 3), (Qr, 3), (Rr, 3))
    W = _basis(H, du, Ar)
    P = Qr[..., H, :, :]
    v = torch.zeros(lead + (m, n), dtype=Ar.dtype, device=Ar.device)
    Fs, fs = [None] * H, [None] * H
    for t in range(H - 1, -1, -1):
        A, B, Q, R = Ar[..., t, :, :], Br[..., t, :, :], Qr[..., t, :, :], Rr[..., t, :, :]
        PB = P @ B                         # (m, du)
        Hinv = gj_inverse(R + _T(B) @ PB)  # (du, du), SPD
        Hux = _T(PB) @ A                   # (du, m)
        F = -(Hinv @ Hux)                  # feedback gain
        g = _T(B) @ v - W[t]               # (du, n) affine injection
        fs[t] = -(Hinv @ g)                # feedforward
        Fs[t] = F
        v = _T(A) @ v + _T(F) @ g
        P = _sym(Q + _T(A) @ (P @ A) + _T(Hux) @ F)
    x = torch.zeros(lead + (m, n), dtype=Ar.dtype, device=Ar.device)
    rows = []
    for t in range(H):
        u = Fs[t] @ x + fs[t]              # (du, n): row block t of K^-1
        x = Ar[..., t, :, :] @ x + Br[..., t, :, :] @ u
        rows.append(u)
    return _sym(torch.cat(rows, dim=-2))


def associative_scan(combine, elems, reverse: bool = False):
    """Inclusive scan over axis -3 of a tuple of (..., L, r, c) tensors by
    log2(L) Hillis-Steele levels, each one batched combine over the
    (..., L - offset) pairs.

    `combine(earlier, later)` takes two element tuples in time order and
    returns their composition. The prefix scan gives e_0 (x) ... (x) e_k at
    k; with reverse, the suffix scan gives e_k (x) ... (x) e_{L-1}, still
    combining each pair in time order (the JAX package's reversed scan
    hands its operator the later operand first and swaps it back)."""
    L = elems[0].shape[-3]
    offset = 1
    while offset < L:
        head = tuple(e[..., :L - offset, :, :] for e in elems)
        tail = tuple(e[..., offset:, :, :] for e in elems)
        if reverse:
            # S_k <- S_k (x) S_{k+offset} for k < L - offset
            new = combine(head, tail)
            elems = tuple(torch.cat([a, b[..., L - offset:, :, :]], dim=-3)
                          for a, b in zip(new, elems))
        else:
            # S_k <- S_{k-offset} (x) S_k for k >= offset
            new = combine(head, tail)
            elems = tuple(torch.cat([b[..., :offset, :, :], a], dim=-3)
                          for a, b in zip(new, elems))
        offset *= 2
    return elems


def riccati_kinv_pscan(Ar, Br, Qr, Rr) -> torch.Tensor:
    """`riccati_kinv` with both horizon passes as associative scans, of
    depth log2(H) (Sarkka and Garcia-Fernandez's temporal parallelization
    of LQ tracking). Element k is the conditional value function
    V_k(x, z) = (z - A x - b)^T C^+ (z - A x - b) + x^T J x - 2 eta^T x,
    initialized as A = A_k, b = B_k R_k^-1 W_k, C = B_k R_k^-1 B_k^T,
    J = Q_k, eta = 0, and combined (e1 earlier) as
        D = (I + C1 J2)^-1
        A = A2 D A1,   b = A2 D (b1 + C1 eta2) + b2,  C = A2 D C1 A2^T + C2,
        eta = A1^T D^T (eta2 - J2 b1) + eta1,          J = A1^T D^T J2 A1 + J1.
    The suffix element at k+1 gives the value function ahead of step k and
    with it the feedback (F_k, f_k); the forward rollout
    x_{k+1} = (A_k + B_k F_k) x_k + B_k f_k is a prefix scan of affine maps.

    Same contract and shapes as `riccati_kinv`.
    """
    H, m, du = Br.shape[-3:]
    n = H * du
    lead = _lead((Ar, 3), (Br, 3), (Qr, 3), (Rr, 3))
    dt, dev = Ar.dtype, Ar.device
    W = _basis(H, du, Ar)
    Ar, Br = Ar.expand(lead + Ar.shape[-3:]), Br.expand(lead + Br.shape[-3:])
    Qr, Rr = Qr.expand(lead + Qr.shape[-3:]), Rr.expand(lead + Rr.shape[-3:])
    BRi = Br @ gj_inverse(Rr)                                  # (.., H, m, du)
    pad = lambda X, r, c: torch.cat(
        [X, torch.zeros(lead + (1, r, c), dtype=dt, device=dev)], dim=-3)
    elems = (pad(Ar, m, m), pad(BRi @ W, m, n), pad(BRi @ _T(Br), m, m),
             torch.zeros(lead + (H + 1, m, n), dtype=dt, device=dev), Qr)
    eye_m = torch.eye(m, dtype=dt, device=dev)

    def combine(e1, e2):
        A1, b1, C1, h1, J1 = e1
        A2, b2, C2, h2, J2 = e2
        D = gj_inverse(eye_m + C1 @ J2)
        A2D = A2 @ D
        A1tDt = _T(A1) @ _T(D)   # inv(I + J2 C1), C1 and J2 symmetric
        return (A2D @ A1, A2D @ (b1 + C1 @ h2) + b2, _sym(A2D @ (C1 @ _T(A2)) + C2),
                A1tDt @ (h2 - J2 @ b1) + h1, _sym(A1tDt @ (J2 @ A1) + J1))

    S = associative_scan(combine, elems, reverse=True)
    hs, Js = S[3][..., 1:, :, :], S[4][..., 1:, :, :]         # value fn ahead of step k
    BtJ = _T(Br) @ Js                                           # (.., H, du, m)
    Hinv = gj_inverse(Rr + BtJ @ Br)
    F = -(Hinv @ (BtJ @ Ar))                                    # (.., H, du, m)
    f = Hinv @ (W + _T(Br) @ hs)                                # (.., H, du, n)

    def acomp(c1, c2):
        M1, d1 = c1
        M2, d2 = c2
        return M2 @ M1, M2 @ d1 + d2

    _, dp = associative_scan(acomp, (Ar + Br @ F, Br @ f))
    xs = torch.cat([torch.zeros(lead + (1, m, n), dtype=dt, device=dev),
                    dp[..., :-1, :, :]], dim=-3)
    U = F @ xs + f                                              # (.., H, du, n)
    return _sym(U.reshape(lead + (n, n)))


def riccati_kinv_shifted(Ar, Br, Qr, Rr, rho, sigma: float, d=None,
                         pscan: bool = False) -> torch.Tensor:
    """K^-1 of the shifted, optionally Jacobi-scaled condensed Hessian:
    inv(D P D + (sigma + rho) I) (D = diag(d); P + (sigma + rho) I when d
    is None), P the symmetrized condensed Hessian of (Ar, Br, Qr, Rr).
    The scaling x = D x' is a per-(t, channel) control rescaling,
    Br_t diag(d_t) and diag(d_t) Rr_t diag(d_t); the shift is
    blockdiag((sigma + rho) I_du).

    :param rho: a float, or a tensor of the operands' batch shape (a lane
        batch: (B,)), the penalty the ADMM round runs at.
    :param d: None, or (..., n) Jacobi weights, time-major.
    :param pscan: the log-depth scan form (`riccati_kinv_pscan`).
    :return: (..., n, n).
    """
    H, m, du = Br.shape[-3:]
    if d is not None:
        dt = d.reshape(d.shape[:-1] + (H, du))
        Br = Br * dt[..., :, None, :]
        Rr = Rr * dt[..., :, :, None] * dt[..., :, None, :]
    shift = torch.as_tensor(rho, dtype=Br.dtype, device=Br.device) + sigma
    eye = torch.eye(du, dtype=Br.dtype, device=Br.device)
    Rr = Rr + shift[..., None, None, None] * eye
    return (riccati_kinv_pscan if pscan else riccati_kinv)(Ar, Br, Qr, Rr)


def riccati_kinv_batch(Ar, Br, Qr, Rr, rho, sigma: float, d=None,
                       pscan: bool = False) -> torch.Tensor:
    """`riccati_kinv_shifted` over a lane batch, in one batched pass.

    :param Ar: (B, H, m, m); :param Br: (B, H, m, du) per-lane dynamics.
    :param Qr: (H+1, m, m); :param Rr: (H, du, du) shared costs (or with a
        leading B).
    :param rho: (B,) per-lane penalties; :param d: None or (B, n).
    :return: (B, n, n).
    """
    B = Ar.shape[0]
    if Ar.dim() != 4 or Br.shape[0] != B or tuple(torch.as_tensor(rho).shape) != (B,):
        raise ValueError(f"riccati_kinv_batch: Ar {tuple(Ar.shape)}, Br {tuple(Br.shape)} "
                         f"and rho {tuple(torch.as_tensor(rho).shape)} need one lane axis B")
    return riccati_kinv_shifted(Ar, Br, Qr, Rr, rho, sigma, d=d, pscan=pscan)
