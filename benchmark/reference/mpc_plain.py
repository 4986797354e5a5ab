"""Plain closed-loop MPC of the benchmark's quantum-control configurations.

The receding-horizon loop of arXiv:2201.05266 as the benchmark's
configurations state it, written out in plain PyTorch from the
configuration files: a bilinear Liouville model discretized to a given
order, linearized along each lane's guess trajectory, the horizon condensed
into one box QP, that QP solved by a fixed budget of relaxed ADMM rounds
(OSQP's rho rebalance between rounds; where a budget states `scale`, in
Jacobi-equilibrated coordinates), a line-searched SQP on the first two
steps and one warm single-shot solve a step after, and the exact plant step:
rho' = U rho U^H, or, where the plant has collapse operators, the
exponential of its Lindbladian applied to vec(rho). Every lane runs every
step; a lane that is done stays as it is.

It imports nothing of the program under test, and takes nothing from it
but what it judges. `Arith` sets its precision: "float64" is the reference
the benchmark compares against; "tf32" is the control: float32, with the
inputs of every matrix product that a library GEMM computes rounded to
TF32's 10-bit mantissa (what enabling TF32 on the card does to them:
linearize, condense, the QP's cost and rollout, the Newton-Schulz inverse,
the plant's conjugation or its propagator's product with the state), the
arithmetic of the QP's ADMM and of the plant's matrix exponential in plain
float32 (hand-written kernels, which TF32 does not reach; so is the Jacobi
scaling of a scaled QP, which is elementwise), and the two
float64 islands the program keeps in float32 (the line-search fit, the
last Newton-Schulz residual) in float64.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional

import numpy as np
import torch


class Arith:
    """The reference's precision and device."""

    MODES = ("float64", "tf32")

    def __init__(self, mode: str = "float64", device="cpu"):
        if mode not in self.MODES:
            raise ValueError(f"mode={mode!r} is not one of {self.MODES}")
        self.mode = mode
        self.real = torch.float64 if mode == "float64" else torch.float32
        self.cplx = torch.complex128 if mode == "float64" else torch.complex64
        self.device = torch.device(device)

    def round(self, t: torch.Tensor) -> torch.Tensor:
        """t as a TF32 product reads it (nearest, ties away), in tf32 mode."""
        if self.mode != "tf32" or t.dtype in (torch.float64, torch.complex128):
            return t
        if t.is_complex():
            return torch.view_as_complex(self.round(torch.view_as_real(t.resolve_conj()).contiguous()))
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    def mm(self, a, b):
        """A library GEMM."""
        return self.round(a) @ self.round(b)

    def ein(self, spec: str, *ops):
        return torch.einsum(spec, *(self.round(o) for o in ops))

    def c(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, complex)).to(self.device, self.cplx)

    def r(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, float)).to(self.device, self.real)


@dataclasses.dataclass(frozen=True)
class Problem:
    """One configuration's control problem (numpy, complex128 / float64).

    model_H: [H0, H1, ..] of the model; plant_H: the nominal plant's, whose
    drift H0 each lane scales by (1 + eps); x0, target: row-major vec(rho);
    X_targ (dim_x, n_steps + H + 1), U_targ (dim_u, n_steps + H); model_c,
    plant_c: the (d, d) collapse operators L of the model's and the plant's
    dissipators D[L], which no detuning scales (none: a closed system)."""

    model_H: list
    plant_H: list
    dt: float
    horizon: int
    n_steps: int
    order: int
    x0: np.ndarray
    target: np.ndarray
    X_targ: np.ndarray
    U_targ: np.ndarray
    Q: np.ndarray
    Qf: np.ndarray
    R: np.ndarray
    sat: float
    du: float
    model_c: tuple = ()
    plant_c: tuple = ()

    @property
    def dim_u(self) -> int:
        return len(self.model_H) - 1


@dataclasses.dataclass(frozen=True)
class QPBudget:
    """A fixed-budget ADMM solve: `rounds` of `iters` steps, the inverse
    of K = P + (sigma + rho) I by "gj" (exact) or "ns" (cold Newton-Schulz,
    `ns_iters` steps a round); with `scale`, solved in the Jacobi-equilibrated
    coordinates x' = x / d, d = diag(P)^-1/2 (`solve_box_qp`)."""

    rounds: int
    iters: int
    rho0: float = 0.1
    sigma: float = 1e-6
    alpha: float = 1.6
    eps_abs: float = 1e-6
    eps_rel: float = 1e-6
    accept_abs: float = 1e-3
    accept_rel: float = 1e-3
    kinv: str = "gj"
    ns_iters: int = 30
    scale: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "QPBudget":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class LoopBudget:
    """The loop's schedule: SQP iterations of each warm step (steps 0 and
    1; past the tuple's end its last entry), the warm and steady QPs, and
    whether a steady QP starts from the previous solve's shifted dual and
    rho (else cold)."""

    warm_iters: tuple
    warm_qp: QPBudget
    steady_qp: QPBudget
    carry_duals: bool
    step_tol: float = 1e-4

    @classmethod
    def from_dict(cls, d: dict) -> "LoopBudget":
        return cls(warm_iters=tuple(d["warm_iters"]), warm_qp=QPBudget.from_dict(d["warm_qp"]),
                   steady_qp=QPBudget.from_dict(d["steady_qp"]),
                   carry_duals=bool(d["carry_duals"]), step_tol=float(d.get("step_tol", 1e-4)))


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------


def liouvillian(Hm: np.ndarray) -> np.ndarray:
    """-i [H, .] on row-major vec(rho)."""
    eye = np.eye(Hm.shape[0])
    return -1j * (np.kron(Hm, eye) - np.kron(eye, Hm.T))


def dissipator(L: np.ndarray) -> np.ndarray:
    """D[L] rho = L rho L^dag - 1/2 {L^dag L, rho} on row-major vec(rho):
    L (x) conj(L) - 1/2 (L^dag L (x) I + I (x) (L^dag L)^T)."""
    eye = np.eye(L.shape[0])
    LdL = L.conj().T @ L
    return np.kron(L, L.conj()) - 0.5 * (np.kron(LdL, eye) + np.kron(eye, LdL.T))


def discretize(prob: Problem, order: Optional[int] = None):
    """The order-k Taylor step of dx/dt = (A0 + sum_i u_i A_i) x with u held
    over dt: exp(dt A(u)) ~ sum_{m <= k} dt^m / m! A(u)^m, expanded into
    monomials of u, A0 = -i[H0, .] + sum_L D[L] over model_c. :return:
    (exponents (L, dim_u) int, operators (L, dim_x, dim_x) complex128)."""
    order = prob.order if order is None else order
    gens = [liouvillian(np.asarray(h, complex)) for h in prob.model_H]
    for L in prob.model_c:
        gens[0] = gens[0] + dissipator(np.asarray(L, complex))
    dim_x, dim_u = gens[0].shape[0], len(gens) - 1
    bins: dict = {}
    for m in range(order + 1):
        for seq in itertools.product(range(dim_u + 1), repeat=m):
            op = np.eye(dim_x, dtype=complex)
            for i in seq:
                op = op @ gens[i]
            key = tuple(sum(1 for i in seq if i == j + 1) for j in range(dim_u))
            bins[key] = bins.get(key, 0) + prob.dt ** m / math.factorial(m) * op
    keys = sorted(bins)
    return np.array(keys, dtype=np.int64).reshape(len(keys), dim_u), np.stack([bins[k] for k in keys])


class Model:
    """x+ = sum_l u^e_l M_l x along lane trajectories."""

    def __init__(self, prob: Problem, ar: Arith, order: Optional[int] = None):
        exps, mats = discretize(prob, order)
        self.exps = exps
        self.mats = ar.c(mats)
        self.ar = ar

    def _mono(self, U):
        """u^e (B, H, L) and d u^e / d u_j (B, H, L, dim_u) of U (B, dim_u, H)."""
        Ut = U.transpose(1, 2)                                     # (B, H, dim_u)
        L, dim_u = self.exps.shape

        def power(e):
            out = torch.ones_like(Ut[..., 0])
            for j in range(dim_u):
                for _ in range(int(e[j])):
                    out = out * Ut[..., j]
            return out

        c = torch.stack([power(e) for e in self.exps], dim=-1)
        dc = torch.stack([torch.stack([
            float(e[j]) * power(e - np.eye(dim_u, dtype=np.int64)[j]) if e[j] > 0
            else torch.zeros_like(Ut[..., 0]) for j in range(dim_u)], dim=-1)
            for e in self.exps], dim=-2)
        return c, dc

    def linearize(self, X, U):
        """A_t, B_t, Delta_t of the model along X (B, dim_x, H), U (B, dim_u, H):
        (B, H, dim_x, dim_x), (B, H, dim_x, dim_u), (B, H, dim_x); the model
        is linear in x, so Delta_t = -B_t u_t."""
        ar = self.ar
        c, dc = self._mono(U)
        A_s = ar.ein("bhl,lxy->bhxy", c.to(ar.cplx), self.mats)
        NX = ar.ein("lxy,byh->bhlx", self.mats, X)
        B_s = ar.ein("bhlx,bhlj->bhxj", NX, dc.to(ar.cplx))
        D_s = -ar.ein("bhxj,bjh->bhx", B_s, U.to(ar.cplx))
        return A_s, B_s, D_s


# --------------------------------------------------------------------------
# condensed QP
# --------------------------------------------------------------------------


def condense(ar: Arith, A_s, B_s, D_s, x_init):
    """x = w + M vec(U), vec(U) time-major: w (B, H+1, dim_x), M (B, H+1,
    dim_x, H, dim_u)."""
    Bn, H, dim_x, dim_u = B_s.shape
    w_t = x_init
    M_t = torch.zeros((Bn, dim_x, H, dim_u), dtype=ar.cplx, device=ar.device)
    ws, Ms = [w_t], [M_t]
    for t in range(H):
        w_t = D_s[:, t] + ar.mm(A_s[:, t], w_t[..., None])[..., 0]
        M_t = ar.ein("bxy,byhd->bxhd", A_s[:, t], M_t)
        M_t[:, :, t, :] += B_s[:, t]
        ws.append(w_t)
        Ms.append(M_t)
    return torch.stack(ws, dim=1), torch.stack(Ms, dim=1)


def qp_cost(ar: Arith, w, M, X_ref, U_ref, Q_s, R):
    """P (B, n, n), q (B, n) of U^T P U + 2 q^T U + c."""
    Bn, Hp1, dim_x, H, dim_u = M.shape
    n = H * dim_u
    Mf = M.reshape(Bn, Hp1, dim_x, n)
    e = w - X_ref.T
    QM = ar.ein("txy,btyn->btxn", Q_s, Mf)
    Qe = ar.ein("txy,bty->btx", Q_s, e)
    P = ar.ein("btxn,btxm->bnm", Mf.conj(), QM).real
    q = ar.ein("btxn,btx->bn", Mf.conj(), Qe).real
    Pu = torch.block_diag(*([R] * H))
    ubm = U_ref.T.reshape(n)
    return P + Pu, q - ar.mm(Pu, ubm)


def box(prob: Problem, ar: Arith, u_prev, B: int):
    """|u_t| <= sat, and |u_0 - u_prev| <= du on the first step."""
    dim_u, H = prob.dim_u, prob.horizon
    lb = torch.full((B, H * dim_u), -prob.sat, dtype=ar.real, device=ar.device)
    ub = -lb
    lb[:, :dim_u] = torch.clamp(u_prev - prob.du, min=-prob.sat)
    ub[:, :dim_u] = torch.clamp(u_prev + prob.du, max=prob.sat)
    return lb, ub


def newton_schulz(ar: Arith, K, iters: int):
    """Cold Newton-Schulz inverse X <- X (2I - K X) from K^T / (|K|_1 |K|_inf);
    in float32 the last step's residual I - K X is formed in float64."""
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    n1 = K.abs().sum(dim=-2).amax(dim=-1)
    ninf = K.abs().sum(dim=-1).amax(dim=-1)
    X = K.transpose(-1, -2) / (n1 * ninf)[..., None, None]
    for i in range(iters):
        if i == iters - 1 and K.dtype == torch.float32:
            Rr = eye.double() - K.double() @ X.double()
            X = X + ar.mm(X, Rr.to(K.dtype))
        else:
            X = ar.mm(X, 2.0 * eye - ar.mm(K, X))
    return X


def jacobi_scale(P, q, lb, ub, x0, y0):
    """The box QP in the coordinates x' = x / d, d = diag(P)^-1/2: P' = D P D
    (unit diagonal), q' = d q, the box and x0 over d, and the box's dual
    y0' = d y0. :return: (P', q', lb', ub', x0', y0', d)."""
    d = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(P, dim1=-2, dim2=-1), min=1e-12))
    return (P * d[..., :, None] * d[..., None, :], q * d, lb / d, ub / d, x0 / d,
            None if y0 is None else y0 * d, d)


def _stats(P, q, x, z, y, d=None):
    """(prim, dual, xmax, zmax, pxmax, qmax, ymax) of each lane; of a QP
    scaled by d, in the original coordinates: x = d x', so primal rows are
    weighted by d, and P x + q + y = (P' x' + q' + y') / d."""
    mx = lambda v: v.abs().amax(dim=-1)
    wp = (lambda v: v) if d is None else (lambda v: d * v)
    wd = (lambda v: v) if d is None else (lambda v: v / d)
    Px = (P @ x[..., None])[..., 0]
    return (mx(wp(x - z)), mx(wd(Px + q + y)), mx(wp(x)), mx(wp(z)), mx(wd(Px)), mx(wd(q)),
            mx(wd(y)))


def _accepted(stats, eps_abs, eps_rel, acc_abs, acc_rel):
    prim, dual, xmax, zmax, pxmax, qmax, ymax = stats
    ps = torch.maximum(xmax, zmax)
    ds = torch.maximum(pxmax, torch.maximum(qmax, ymax))
    return ((prim <= torch.maximum(eps_abs + eps_rel * ps, acc_abs + acc_rel * ps))
            & (dual <= torch.maximum(eps_abs + eps_rel * ds, acc_abs + acc_rel * ds)))


def solve_box_qp(ar: Arith, bud: QPBudget, P, q, lb, ub, x0, y0=None, rho0=None):
    """min 1/2 x^T P x + q^T x on lb <= x <= ub by `bud.rounds` rounds of
    `bud.iters` relaxed ADMM steps; rho rebalanced after each round on the
    lanes that round did not accept (OSQP's rule). rho0 <= 0 (or None) is
    cold: bud.rho0 times the mean of diag P.

    With `bud.scale` the rounds run on the Jacobi-equilibrated QP
    (`jacobi_scale`): x0 and the dual y0 come in unscaled and rho0 in the
    scaled space; the cold rho and its clamps are taken against the mean of
    diag P', K^-1 is that of P' + (sigma + rho) I, and the residuals, the
    acceptance and the rebalance read the original coordinates (`_stats`).
    :return: (z, y, rho, accepted), the last round's acceptance; z and y
        unscaled, rho in the solver's (with `scale`, the scaled) space."""
    n = q.shape[-1]
    P = 0.5 * (P + P.transpose(-1, -2))
    d = None
    if bud.scale:
        P, q, lb, ub, x0, y0, d = jacobi_scale(P, q, lb, ub, x0, y0)
    eye = torch.eye(n, dtype=P.dtype, device=P.device)
    ds = torch.clamp(torch.diagonal(P, dim1=-2, dim2=-1).mean(dim=-1), min=1e-12)
    rho = bud.rho0 * ds
    if rho0 is not None:
        rho = torch.where(rho0 > 0, torch.clamp(rho0, 1e-8 * ds, 1e8 * ds), rho)
    x = torch.minimum(torch.maximum(x0, lb), ub)
    z = x
    y = torch.zeros_like(q) if y0 is None else y0
    sig, alpha = bud.sigma, bud.alpha
    for _ in range(bud.rounds):
        K = P + (sig + rho)[:, None, None] * eye
        Kinv = torch.linalg.inv(K) if bud.kinv == "gj" else newton_schulz(ar, K, bud.ns_iters)
        r = rho[:, None]
        for _ in range(bud.iters):
            x = (Kinv @ (sig * x - q + r * z - y)[..., None])[..., 0]
            z_arg = alpha * x + (1 - alpha) * z
            z_new = torch.minimum(torch.maximum(z_arg + y / r, lb), ub)
            y = y + r * (z_arg - z_new)
            z = z_new
        stats = _stats(P, q, x, z, y, d)
        acc = _accepted(stats, bud.eps_abs, bud.eps_rel, bud.accept_abs, bud.accept_rel)
        prim, dual, xmax, zmax, pxmax, qmax, ymax = stats
        prim_s = prim / torch.clamp(torch.maximum(xmax, zmax), min=1e-12)
        dual_s = dual / torch.clamp(torch.maximum(pxmax, torch.maximum(qmax, ymax)), min=1e-12)
        ratio = torch.sqrt(prim_s / torch.clamp(dual_s, min=1e-16))
        rho = torch.where(acc, rho, torch.clamp(rho * ratio, 1e-8 * ds, 1e8 * ds))
    if d is not None:
        z, y = d * z, y / d
    return z, y, rho, acc


def objective(X, U, X_ref, U_ref, Q_s, R):
    """Tracking cost of X (B, dim_x, H+1), U (B, dim_u, H) in float64."""
    ex = (X - X_ref).transpose(1, 2)
    eu = (U - U_ref).transpose(1, 2)
    return (torch.einsum("btx,txy,bty->b", ex.conj(), Q_s, ex).real
            + torch.einsum("bti,ij,btj->b", eu, R, eu))


# --------------------------------------------------------------------------
# the loop
# --------------------------------------------------------------------------


def expm(G):
    """exp(G) of a batch (B, d, d) by Taylor degree 18 after scaling to a
    1-norm <= 1/2, then squaring (error below float64's rounding)."""
    norm = float(G.abs().sum(dim=-2).amax()) if G.numel() else 0.0
    s = max(0, math.ceil(math.log2(max(norm, 1e-300) / 0.5)))
    Gs = G / 2.0 ** s
    eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
    E = eye + Gs / 18
    for k in range(17, 0, -1):
        E = eye + (Gs @ E) / k
    for _ in range(s):
        E = E @ E
    return E


# generator entries of one chunk of the open plant step's lane-steps: 256 MB
# in complex128, so 256 lane-steps of a 256 x 256 Liouvillian
OPEN_CHUNK = 2 ** 24


def plant_step(prob: Problem, ar: Arith, H0_lanes, x, u):
    """The exact step of each lane-step's plant, H = H0_b + sum_j u_j H1_j:
    rho' = U rho U^H with U = exp(-i dt H); where the plant has collapse
    operators, x' = exp(dt (-i[H, .] + sum_L D[L])) x on x = vec(rho)."""
    H1 = ar.c(np.stack(prob.plant_H[1:]))
    Hm = H0_lanes + torch.einsum("bj,jcd->bcd", u.to(ar.cplx), H1)
    if prob.plant_c:
        return _open_step(prob, ar, Hm, x)
    Um = expm((-1j * prob.dt) * Hm)
    d = Hm.shape[-1]
    rho = x.reshape(-1, d, d)
    return ar.mm(ar.mm(Um, rho), Um.conj().transpose(-1, -2)).reshape(x.shape)


def _open_step(prob: Problem, ar: Arith, Hm, x):
    """x' = exp(dt (-i[H_b, .] + D)) x of each lane-step's H_b, D the plant's
    summed dissipators, in chunks of OPEN_CHUNK generator entries."""
    d = Hm.shape[-1]
    D = ar.c(sum(dissipator(np.asarray(L, complex)) for L in prob.plant_c))
    eye = torch.eye(d, dtype=ar.cplx, device=ar.device)[None]
    rows = max(1, OPEN_CHUNK // d ** 4)
    out = []
    for k in range(0, Hm.shape[0], rows):
        Hk = Hm[k:k + rows]
        LH = -1j * (torch.kron(Hk, eye) - torch.kron(eye, Hk.transpose(-1, -2).contiguous()))
        E = expm(prob.dt * (LH + D))
        out.append(ar.mm(E, x[k:k + rows, :, None])[..., 0])
    return torch.cat(out)


def lane_drifts(prob: Problem, ar: Arith, eps) -> torch.Tensor:
    """Each lane's plant drift H0 (1 + eps_b): (B, d, d)."""
    H0 = torch.as_tensor(np.asarray(prob.plant_H[0], complex))
    return (H0[None] * (1.0 + torch.as_tensor(eps, dtype=torch.float64))[:, None, None]).to(
        ar.device, ar.cplx)


def closed_loop(prob: Problem, bud: LoopBudget, eps, ar: Arith, order: Optional[int] = None,
                record: bool = False, n_steps: Optional[int] = None) -> dict:
    """Run every lane of the detunings `eps` (B,) through the first
    `n_steps` steps (all of prob.n_steps when None).

    :return: {"final_x" (B, dim_x), "exit_code" (B,) int (0 completed, 2 a
        QP not accepted, 3 a non-finite objective)} and with `record` "xs"
        (B, dim_x, n_steps + 1) and "us" (B, dim_u, n_steps) (0 where no
        control was applied)."""
    H, dim_u, n = prob.horizon, prob.dim_u, prob.horizon * prob.dim_u
    B = len(eps)
    model = Model(prob, ar, order)
    H0b = lane_drifts(prob, ar, eps)
    X_targ, U_targ = ar.c(prob.X_targ), ar.r(prob.U_targ)
    Q_s = ar.c(np.concatenate([np.broadcast_to(prob.Q, (H,) + prob.Q.shape), prob.Qf[None]]))
    R = ar.r(prob.R)
    Q64, R64 = Q_s.to(torch.complex128), R.double()
    dim_x = prob.x0.shape[0]
    x_cur = ar.c(prob.x0).expand(B, -1).clone()
    Xg_c = x_cur[:, :, None].expand(-1, -1, H + 1).clone()
    Ug_c = torch.zeros((B, dim_u, H), dtype=ar.real, device=ar.device)
    u_last = U_targ[:, 0].expand(B, -1).clone()
    code = torch.zeros(B, dtype=torch.int64, device=ar.device)
    done = torch.zeros(B, dtype=torch.bool, device=ar.device)
    y_c = torch.zeros((B, n), dtype=ar.real, device=ar.device)
    rho_c = torch.zeros(B, dtype=ar.real, device=ar.device)
    xs = us = None
    if record:
        steps = prob.n_steps if n_steps is None else n_steps
        xs = torch.zeros((B, dim_x, steps + 1), dtype=ar.cplx, device=ar.device)
        us = torch.zeros((B, dim_u, steps), dtype=ar.real, device=ar.device)
        xs[:, :, 0] = x_cur
    lane = lambda m, t: m.reshape(m.shape + (1,) * (t.dim() - 1))

    for step in range(prob.n_steps if n_steps is None else n_steps):
        start = max(step - 1, 0)
        X_ref = X_targ[:, start:start + H + 1]
        U_ref = U_targ[:, start:start + H]
        u_prev = u_last if step > 1 else U_ref[:, 0].expand(B, -1)
        lb, ub = box(prob, ar, u_prev, B)
        # the SQP state of every lane
        Xg, Ug, X_opt, U_opt = Xg_c, Ug_c, Xg_c, Ug_c
        s_done = torch.zeros(B, dtype=torch.bool, device=ar.device)
        s_code = torch.zeros(B, dtype=torch.int64, device=ar.device)
        y, rho = y_c, rho_c
        warm = step <= 1
        n_it = bud.warm_iters[min(step, len(bud.warm_iters) - 1)] if warm else 1
        for _ in range(n_it):
            if bool(s_done.all()):
                break
            A_s, B_s, D_s = model.linearize(Xg[:, :, :H], Ug)
            w, M = condense(ar, A_s, B_s, D_s, x_cur)
            P, q = qp_cost(ar, w, M, X_ref, U_ref, Q_s, R)
            # the carried dual is unscaled and rho in the space of the solve
            # that returned it: across the warm/steady seam, where only one
            # phase is scaled, y is scaled by the solve that takes it and rho
            # passes as it is, clamped against that solve's diagonal
            seeded = not warm and bud.carry_duals
            z, y_n, rho_n, acc = solve_box_qp(
                ar, bud.warm_qp if warm else bud.steady_qp, P, q, lb, ub,
                Ug.transpose(1, 2).reshape(B, n), y if seeded else None, rho if seeded else None)
            Mv = ar.mm(M.reshape(B, (H + 1) * dim_x, n), z.to(ar.cplx)[..., None])[..., 0]
            X_n = (w + Mv.reshape(B, H + 1, dim_x)).transpose(1, 2)
            U_n = z.reshape(B, H, dim_u).transpose(1, 2)
            obj = objective(X_n.to(torch.complex128), U_n.double(), X_ref.to(torch.complex128),
                            U_ref.double(), Q64, R64)
            c_n = torch.where(~acc, 2, torch.where(~torch.isfinite(obj), 3, 0))
            if warm:
                alpha, small = line_search(Xg, Ug, X_n, U_n, X_ref, U_ref, Q64, R64, bud.step_tol)
                it_done = small | (c_n > 0)
            else:
                alpha = torch.ones(B, dtype=torch.float64, device=ar.device)
                it_done = torch.ones(B, dtype=torch.bool, device=ar.device)
            ok = c_n == 0
            stp = (ok.double() * alpha).to(ar.real)
            Xg_n = Xg + lane(stp, Xg) * (X_n - Xg)
            Ug_n = Ug + lane(stp, Ug) * (U_n - Ug)
            y_n = torch.where(ok[:, None], y_n, y)
            rho_n = torch.where(ok, rho_n, rho)
            keep = lambda old, new: torch.where(lane(s_done, old), old, new)
            Xg, Ug, X_opt, U_opt = keep(Xg, Xg_n), keep(Ug, Ug_n), keep(X_opt, X_n), keep(U_opt, U_n)
            y, rho = keep(y, y_n), keep(rho, rho_n)
            s_code = keep(s_code, c_n)
            s_done = keep(s_done, it_done)
        # advance
        u = U_opt[:, :, 0]
        failed = s_code > 0
        x_next = plant_step(prob, ar, H0b, x_cur, u)
        if record:
            us[:, :, step] = torch.where((~(done | failed))[:, None], u, 0.0)
        hold = lambda old, new: torch.where(lane(done | failed, old), old, new)
        frozen = lambda old, new: torch.where(lane(done, old), old, new)
        shift = lambda G: torch.cat([G[:, :, 1:], G[:, :, -1:]], dim=2)
        x_cur = hold(x_cur, x_next)
        Xg_c, Ug_c = frozen(Xg_c, shift(Xg)), frozen(Ug_c, shift(Ug))
        u_last = hold(u_last, u)
        code = frozen(code, torch.where(failed, s_code, 0))
        y_c = frozen(y, torch.cat([y[:, dim_u:], y[:, -dim_u:]], dim=1))
        rho_c = rho
        done = done | failed
        if record:
            xs[:, :, step + 1] = x_cur
    out = {"final_x": x_cur, "exit_code": code}
    if record:
        out.update(xs=xs, us=us)
    return out


def line_search(Xg, Ug, X_n, U_n, X_ref, U_ref, Q64, R64, step_tol: float):
    """The exact step along (new - guess) on the quadratic tracking cost,
    fitted in float64 from three values and clamped to [0, 1]; small: the
    step moved the iterate by less than step_tol."""
    w = lambda t: t.to(torch.complex128 if t.is_complex() else torch.float64)
    Xg, Ug = w(Xg), w(Ug)
    dX, dU = w(X_n) - Xg, w(U_n) - Ug
    Xr, Ur = w(X_ref), w(U_ref)
    phi = lambda a: objective(Xg + a * dX, Ug + a * dU, Xr, Ur, Q64, R64)
    p0, ph, p1 = phi(0.0), phi(0.5), phi(1.0)
    a = 2.0 * (p1 + p0 - 2.0 * ph)
    b = p1 - p0 - a
    curved = a.abs() > 1e-30
    alpha = torch.where(curved, -b / (2.0 * torch.where(curved, a, torch.ones_like(a))),
                        torch.ones_like(a))
    alpha = torch.clamp(torch.where(torch.isfinite(alpha), alpha, torch.ones_like(alpha)), 0, 1)
    dz = torch.sqrt(dX.abs().pow(2).sum(dim=(1, 2)) + dU.abs().pow(2).sum(dim=(1, 2)))
    return alpha, alpha * dz < step_tol


def fleet(prob: Problem, bud: LoopBudget, eps, ar: Arith, rescue: Optional[dict] = None,
          record: bool = False) -> dict:
    """`closed_loop` over the lanes, then, with `rescue` = {"threshold": f,
    "order": k}, the lanes that ended below f or did not complete run again
    on a model of order k, and each keeps the second run's result where that
    run completed with a higher fidelity."""
    out = closed_loop(prob, bud, eps, ar, record=record)
    if rescue is None:
        return out
    fid = fidelity(prob, out["final_x"])
    marginal = (fid < rescue["threshold"]) | (out["exit_code"] != 0)
    idx = torch.nonzero(marginal).flatten()
    if len(idx):
        sub = closed_loop(prob, bud, np.asarray(eps)[idx.cpu().numpy()], ar,
                          order=rescue["order"], record=record)
        better = (fidelity(prob, sub["final_x"]) > fid[idx]) & (sub["exit_code"] == 0)
        take = idx[better]
        # the rescue re-runs a lane's outcome; the record stays the first run's
        for key in ("final_x", "exit_code"):
            out[key][take] = sub[key][better]
    return out


def fidelity(prob: Problem, final_x) -> torch.Tensor:
    """Re <target, x> / |target|^2 a lane, float64."""
    t = torch.as_tensor(np.asarray(prob.target, complex)).to(final_x.device)
    x = final_x.to(torch.complex128)
    return (x @ t.conj()).real / float(np.real(np.vdot(prob.target, prob.target)))
