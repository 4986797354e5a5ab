"""The model phase of small condensed QPs: the wrapper of the CUDA kernel
csrc/condense_small.cu and its plain PyTorch version.

`condense_small` linearizes a shared bilinear model along each lane's guess
(ops/bilinear.model_along_traj), condenses the horizon and assembles the box
QP (solvers/condense.qp_data) in one launch: P, q, lb, ub, w and M. It
replaces no Pallas kernel; the JAX package leaves these contractions to XLA.
On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.bilinear import BilinearModel, model_along_traj
from ..ops.library import size_of_library
from ..solvers.condense import qp_data
from . import _build

# the kernel's limits: a team of at most 16 threads a lane owns the rows of
# the state and the columns of the QP; the monomials and their exponents
# travel in the launch's arguments
MAX_DIM_X = 16
MAX_N = 16
MAX_LM = 16
_MAX_DIM_U = 16


class _Args(ctypes.Structure):
    """csrc/condense_small.cu's CondenseArgs: strides in elements, sizes,
    the box, the (Lm, dim_u) exponents of the non-constant monomials."""
    _fields_ = [(name, ctypes.c_longlong * k) for name, k in (
        ("sA", 2), ("sN", 3), ("sX", 3), ("sU", 3), ("sx0", 2), ("sXbm", 2), ("sUbm", 2),
        ("sQ", 3), ("sR", 3), ("sup", 2))] + [
        (name, ctypes.c_int) for name in ("B", "dim_x", "H", "dim_u", "Lm", "slew")] + [
        ("sat", ctypes.c_float), ("du", ctypes.c_float),
        ("powers", ctypes.c_ubyte * (MAX_LM * _MAX_DIM_U))]


def fits(dim_x: int, n: int, Lm: int) -> bool:
    """Whether the kernel takes a model of dim_x states and Lm non-constant
    monomials at n = H dim_u controls a horizon."""
    return 1 <= dim_x <= MAX_DIM_X and 1 <= n <= MAX_N and 1 <= Lm <= MAX_LM


def condense_small_work(B: int, dim_x: int, H: int, dim_u: int, Lm: int):
    """The work of one `condense_small` call, counted from its shapes (FMA =
    2 flops, a complex multiply-add 8). Per lane and step t: A_t (4 dim_x^2
    Lm), N x_t (8 dim_x^2 Lm), B_t (4 dim_x Lm dim_u), Delta_t and w_{t+1}
    (4 dim_x dim_u + 8 dim_x^2), M's t dim_u nonzero columns (8 dim_x^2 t
    dim_u) and, over the (t + 1) dim_u columns k of M_{t+1}, Q^H M (8 dim_x^2
    k), q (4 dim_x k) and P (4 dim_x k^2). Bytes: X, U, x_init and u_prev
    read, P, q, lb, ub, w and M written, once each a lane; the shared A, N,
    Q, X_bm, U_bm and R once a call.

    :return: (flops, bytes).
    """
    n = H * dim_u
    flops = 0
    for t in range(H):
        k = (t + 1) * dim_u
        flops += (12 * dim_x * dim_x * Lm + 4 * dim_x * Lm * dim_u + 4 * dim_x * dim_u
                  + 8 * dim_x * dim_x + 8 * dim_x * dim_x * t * dim_u
                  + 8 * dim_x * dim_x * k + 4 * dim_x * k + 4 * dim_x * k * k)
    lane = (8 * dim_x * H + 4 * dim_u * H + 8 * dim_x + 4 * dim_u
            + 4 * (n * n + 3 * n) + 8 * (H + 1) * dim_x * (1 + n))
    shared = (8 * dim_x * dim_x * (1 + Lm) + 8 * (H + 1) * dim_x * (1 + dim_x)
              + 4 * H * dim_u * (1 + dim_u))
    return B * flops, B * lane + shared


def condense_small_ref(model: BilinearModel, X, U, x_init, X_bm, U_bm, Q_s, R_s,
                       u_prev=None, sat=None, du=None):
    """Plain version of the kernel: model_along_traj, then qp_data, on any
    device and dtype. :return: (P, q, lb, ub, w, M)."""
    A_s, B_s, D_s = model_along_traj(model, X, U)
    return qp_data(x_init, X_bm, U_bm, Q_s, R_s, A_s, B_s, D_s, u_prev, sat, du)


# random shared models of (dim_x, H, dim_u), order 2, one for each of the
# kernel's 15 instances (DX, W) (DX the power of two >= dim_x, W that >=
# max(dim_x, n = H dim_u); of them the presets reach only (4, 16) and
# (16, 16)); (3, 5, 2) is the shape of the CPU tests' two-control model
CONDENSE_MODELS = ((1, 1, 1), (1, 2, 1), (1, 2, 2), (1, 7, 1), (1, 5, 3), (2, 1, 2),
                   (2, 3, 1), (2, 4, 2), (2, 12, 1), (3, 4, 1), (4, 3, 2), (3, 5, 2),
                   (5, 7, 1), (8, 8, 2), (9, 3, 3))


def condense_input(case, B: int, seed: int = 0, device="cuda", dtype=torch.float32) -> dict:
    """condense_small's arguments: at a preset's shapes (`case` its name),
    its model, costs and a window of its targets; at a random shared model
    (`case` (dim_x, H, dim_u), order 2: A of norm 0.9, Q not Hermitian nor
    R symmetric, so an exchange of a transpose for the other shows), its own
    costs and targets, sat 0.5 and du 0.2. Random guesses within the box,
    the guess X a view of a (B, dim_x, H + 1) tensor, as the runner hands it
    over."""
    from .. import presets
    from ..mpc.driver import bilinear_model

    g = torch.Generator(device=device).manual_seed(seed)
    real = lambda *s: torch.randn(s, generator=g, device=device, dtype=dtype)
    cx = lambda *s: torch.complex(real(*s), real(*s))
    if isinstance(case, str):
        sc = presets.PRESETS[case](device=device, dtype=dtype)
        model = bilinear_model(sc.model, sc.config)
        H, dim_x, dim_u = sc.config.horizon, model.dim_x, model.dim_u
        sat, du = sc.sat, sc.du
        X_bm, U_bm = sc.X_targ[:, 3:H + 4], sc.U_targ[:, 3:H + 3]
        Q_s = torch.cat([sc.Q.expand(H, -1, -1), sc.Qf[None]], dim=0).to(model.A.dtype)
        R_s = sc.R.expand(H, -1, -1)
    else:
        dim_x, H, dim_u = case
        Lm = size_of_library(2, dim_u) - 1
        A = cx(dim_x, dim_x)
        model = BilinearModel(A=0.9 * A / torch.linalg.matrix_norm(A, 2),
                              N=0.3 * cx(dim_x, Lm, dim_x), dim_u=dim_u, order=2)
        sat, du = 0.5, 0.2
        X_bm, U_bm = 0.5 * cx(dim_x, H + 1), 0.2 * real(dim_u, H)
        G = cx(H + 1, dim_x, dim_x)
        Q_s = G @ G.mH / dim_x + 0.2 * cx(H + 1, dim_x, dim_x)
        Rg = real(H, dim_u, dim_u)
        R_s = Rg @ Rg.mT + 0.1 * torch.eye(dim_u, device=device, dtype=dtype) \
            + 0.2 * real(H, dim_u, dim_u)
    uni = lambda *s: (torch.rand(s, generator=g, device=device, dtype=dtype) * 2 - 1) * sat
    return dict(model=model, X=0.5 * cx(B, dim_x, H + 1)[:, :, :H], U=uni(B, dim_u, H),
                x_init=0.5 * cx(B, dim_x), X_bm=X_bm, U_bm=U_bm, Q_s=Q_s, R_s=R_s,
                u_prev=uni(B, dim_u), sat=sat, du=du)


def _checked(t: torch.Tensor, name: str, shape: tuple, dtype) -> torch.Tensor:
    """t, its conjugation resolved, where it has the shape and dtype."""
    if tuple(t.shape) != shape or t.dtype != dtype:
        raise ValueError(f"condense_small: {name} must be {dtype} {shape}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    return t.resolve_conj()


def condense_small(model: BilinearModel, X, U, x_init, X_bm, U_bm, Q_s, R_s, u_prev=None,
                   sat=None, du=None):
    """The batch's box QPs along each lane's guess: qp_data on
    model_along_traj(model, X, U), in one launch on the card.

    :param model: a shared BilinearModel (not a lane batch), dim_x <= 16 and
        at most 16 non-constant monomials.
    :param X: (B, dim_x, H) complex64 guess states; U: (B, dim_u, H) float32
        guess controls, H dim_u <= 16; x_init (B, dim_x).
    :param X_bm, U_bm, Q_s, R_s, u_prev, sat, du: as qp_data. Any strides:
        the kernel reads views in place.
    :return: (P (B, n, n), q, lb, ub (B, n), w (B, H + 1, dim_x), M (B, H + 1,
        dim_x, H, dim_u)).
    """
    if X.device.type == "cpu":
        return condense_small_ref(model, X, U, x_init, X_bm, U_bm, Q_s, R_s, u_prev, sat, du)
    if X.device.type != "cuda":
        raise ValueError(f"condense_small: unsupported device {X.device}")
    if model.per_lane:
        raise ValueError("condense_small: the kernel takes a shared model, not a lane batch")
    B, dim_x, H = X.shape
    dim_u, Lm, n = model.dim_u, model.polyu_dim, H * model.dim_u
    if not fits(dim_x, n, Lm):
        raise ValueError(f"condense_small: dim_x {dim_x}, n {n}, Lm {Lm} outside the "
                         f"kernel's {MAX_DIM_X}, {MAX_N}, {MAX_LM}")
    c64, f32 = torch.complex64, torch.float32
    R_r = R_s.real if R_s.is_complex() else R_s
    ins = [_checked(t, name, shape, dtype) for t, name, shape, dtype in (
        (model.A, "A", (dim_x, dim_x), c64), (model.N, "N", (dim_x, Lm, dim_x), c64),
        (X, "X", (B, dim_x, H), c64), (U, "U", (B, dim_u, H), f32),
        (x_init, "x_init", (B, dim_x), c64), (X_bm, "X_bm", (dim_x, H + 1), c64),
        (U_bm, "U_bm", (dim_u, H), f32), (Q_s, "Q_s", (H + 1, dim_x, dim_x), c64),
        (R_r.to(f32), "R_s", (H, dim_u, dim_u), f32))]
    slew = du is not None and u_prev is not None
    if slew:
        ins.append(_checked(u_prev.to(f32), "u_prev", (B, dim_u), f32))
    for t in ins:
        if t.device != X.device:
            raise ValueError(f"condense_small: an input on {t.device}, X on {X.device}")
    powers = model.lib_powers()
    args = _Args(B=B, dim_x=dim_x, H=H, dim_u=dim_u, Lm=Lm, slew=int(slew),
                 sat=float("inf") if sat is None else float(sat),
                 du=float(du) if slew else 0.0)
    for field, t in zip(("sA", "sN", "sX", "sU", "sx0", "sXbm", "sUbm", "sQ", "sR", "sup"),
                        ins):
        getattr(args, field)[:] = t.stride()
    for k, p in enumerate(powers.reshape(-1)):
        args.powers[k] = int(p)
    dev = X.device
    P = torch.empty((B, n, n), dtype=f32, device=dev)
    q, lb, ub = (torch.empty((B, n), dtype=f32, device=dev) for _ in range(3))
    w = torch.empty((B, H + 1, dim_x), dtype=c64, device=dev)
    M = torch.empty((B, H + 1, dim_x, H, dim_u), dtype=c64, device=dev)
    ptrs = [t.data_ptr() for t in ins] + ([None] if not slew else [])
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.mpc4q_condense_small(*ptrs, P.data_ptr(), q.data_ptr(), lb.data_ptr(),
                                  ub.data_ptr(), w.data_ptr(), M.data_ptr(),
                                  ctypes.byref(args), stream)
    _build.check(rc, "condense_small")
    condense_small.launches += 1
    return P, q, lb, ub, w, M


condense_small.launches = 0
