"""DMDc model family (counterpart of mpc4quantum_tpu/models/dmdc.py):
immutable dataclasses of tensors with functional updates.

  - `DMDcModel`: read-only y = A_x x + A_u u with A = [A_x | A_u];
  - `DiscrepDMDc`: an offline pinv fit with streaming discrepancy
    corrections over a fixed-capacity, zero-padded, right-aligned snapshot
    buffer (zero columns add nothing to the pinv: pinv([Z | 0]) =
    [pinv(Z); 0]);
  - `OnlineDMDc`: the rank-1 recursive-least-squares update;
  - `HistoryState`: any of them wrapped with a ring of `A` (and `P`)
    snapshots taken every `every` updates, slot 0 pinned to the first.

Every function works on one model or on a lane batch: each tensor field
may carry leading axes (B, ...) in front of its own, and the snapshots
passed to an update carry the same leading axes, (B, dim) for a batch. The
fleet runner refits per lane this way.

Semantics kept from the reference on purpose:
  - the RLS update uses the plain transpose, not the conjugate transpose
    (z^T P z, (y - A z) (P z)^T, (P z)(P z)^T): on complex models the
    Hermitian form would be a different filter;
  - `_shift_in` discounts the whole buffer and then rolls it;
  - the discrepancy rank gate counts singular values of X above
    max(s) * max(X.shape) * eps, and the correction's pinv cuts at
    rtol = rcond (utils/linalg.pinv, the cut of `jnp.linalg.pinv`);
  - discount: a forgetting half-life of k updates is discount 2^(-1/k).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..utils.linalg import cx_mm, pinv


def static(default=dataclasses.MISSING):
    """A dataclass field that is a setting shared by every lane, not a tensor."""
    return dataclasses.field(default=default, metadata={"static": True})


def tree_map(fn: Callable, model, *rest):
    """Apply fn to each tensor field of a model (and of the model a
    HistoryState wraps), field by field across `rest` models of the same
    kind; settings and None fields are kept from `model`."""
    if model is None:
        return None
    if isinstance(model, torch.Tensor):
        return fn(model, *rest)
    changes = {}
    for f in dataclasses.fields(model):
        if f.metadata.get("static"):
            continue
        changes[f.name] = tree_map(fn, getattr(model, f.name),
                                   *(getattr(r, f.name) for r in rest))
    return dataclasses.replace(model, **changes)


def tree_where(mask: torch.Tensor, old, new):
    """Per lane: `old` where mask (B,), else `new`."""
    def pick(a, b):
        return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim())), a, b)
    return tree_map(pick, old, new)


def tile_lanes(model, B: int):
    """A lane batch of B copies of one model (every tensor field gains a
    leading axis B)."""
    return tree_map(lambda t: t.expand(B, *t.shape).clone(), model)


# ---------------------------------------------------------------------------
# Read-only DMDc container
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DMDcModel:
    A: torch.Tensor  # (..., dim_y, dim_x + dim_u)
    dim_y: int = static()
    dim_x: int = static()
    dim_u: int = static()


def dmdc_from_operator(A0: torch.Tensor, dim_y: int, dim_x: int, dim_u: int) -> DMDcModel:
    return DMDcModel(A=A0, dim_y=dim_y, dim_x=dim_x, dim_u=dim_u)


def get_discrete(model):
    """(A_x, A_u) views."""
    return (model.A[..., : model.dim_y, : model.dim_x],
            model.A[..., : model.dim_y, model.dim_x:])


def predict(model, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """y (dim_y, n) from x (dim_x, n) and u (dim_u, n). With a lane batch
    of models (A of shape (B, dim_y, dim_z)), n = B and column b goes
    through lane b's operator."""
    A_x, A_u = get_discrete(model)
    x = x.reshape(model.dim_x, -1)
    u = u.reshape(model.dim_u, -1)
    if model.A.dim() == 2:
        return cx_mm(A_x, x) + cx_mm(A_u, u)
    return (cx_mm(A_x, x.T[..., None]) + cx_mm(A_u, u.T[..., None]))[..., 0].T


# ---------------------------------------------------------------------------
# Offline / discrepancy DMDc
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DiscrepDMDc:
    """Discrepancy-corrected DMDc with a fixed-capacity snapshot buffer."""

    A: torch.Tensor      # (..., dim_y, dim_x + dim_u)
    Y: torch.Tensor      # (..., dim_y, capacity) zero-padded, right-aligned
    X: torch.Tensor      # (..., dim_x, capacity)
    U: torch.Tensor      # (..., dim_u, capacity)
    count: torch.Tensor  # (...,) int64: valid columns (<= capacity)
    dim_y: int = static()
    dim_x: int = static()
    dim_u: int = static()
    capacity: int = static()
    discount: float = static(1.0)
    rcond: float = static(1e-15)

    @property
    def min_rank(self) -> int:
        """The rank of the state history that gates the correction."""
        return self.dim_x


def _stack_z(X, U):
    return X if U is None else torch.cat([X, U.to(X.dtype)], dim=-2)


def discrep_from_data(Y, X, U=None, rcond: float = 1e-15, capacity: Optional[int] = None,
                      discount: float = 1.0) -> DiscrepDMDc:
    """Offline fit A0 = Y pinv([X; U], rcond); the buffers keep the last
    `capacity` columns (all of them when None)."""
    n = Y.shape[-1]
    Z = _stack_z(X, U)
    if U is None:
        U = X.new_zeros(X.shape[:-2] + (0, n))
    A0 = Y @ pinv(Z, rcond).to(Y.dtype)
    cap = n if capacity is None else capacity

    def pad(M):
        out = M.new_zeros(M.shape[:-1] + (cap,))
        k = min(n, cap)
        out[..., cap - k:] = M[..., n - k:]
        return out

    return DiscrepDMDc(A=A0, Y=pad(Y), X=pad(X), U=pad(U.to(X.dtype)),
                       count=torch.full(Y.shape[:-2], min(n, cap), dtype=torch.int64,
                                        device=Y.device),
                       dim_y=Y.shape[-2], dim_x=X.shape[-2], dim_u=U.shape[-2], capacity=cap,
                       discount=discount, rcond=rcond)


def discrep_bootstrap(A0, dim_y: int, dim_x: int, dim_u: int, capacity: int,
                      discount: float = 1.0, rcond: float = 1e-15,
                      dtype: Optional[torch.dtype] = None) -> DiscrepDMDc:
    """An initial operator with an empty buffer."""
    dtype = dtype or A0.dtype
    lead = A0.shape[:-2]
    zeros = lambda d: torch.zeros(lead + (d, capacity), dtype=dtype, device=A0.device)
    return DiscrepDMDc(A=A0, Y=zeros(dim_y), X=zeros(dim_x), U=zeros(dim_u),
                       count=torch.zeros(lead, dtype=torch.int64, device=A0.device),
                       dim_y=dim_y, dim_x=dim_x, dim_u=dim_u, capacity=capacity,
                       discount=discount, rcond=rcond)


def discrep_from_randn(generator: torch.Generator, dim_y: int, dim_x: int, dim_u: int,
                       sigma: float, capacity: int, discount: float = 1.0,
                       rcond: float = 1e-15, dtype=torch.float64, device=None) -> DiscrepDMDc:
    """Bootstrap from a random-normal operator of scale sigma, drawn by
    `generator` (on `device`, the generator's device by default)."""
    device = generator.device if device is None else device
    A0 = sigma * torch.randn((dim_y, dim_x + dim_u), generator=generator, dtype=torch.float64,
                             device=device).to(dtype)
    return discrep_bootstrap(A0, dim_y, dim_x, dim_u, capacity, discount=discount, rcond=rcond)


def discrep_append(d: DiscrepDMDc, Y, X, U) -> DiscrepDMDc:
    """Bulk-load snapshot columns without refitting: they enter
    undiscounted on the right of the buffers."""
    n = Y.shape[-1]

    def shift(buf, M):
        k = min(n, buf.shape[-1])
        out = torch.roll(buf, -n, dims=-1)
        out[..., buf.shape[-1] - k:] = M[..., n - k:].to(buf.dtype)
        return out

    return dataclasses.replace(d, Y=shift(d.Y, Y), X=shift(d.X, X),
                               U=shift(d.U, U) if d.dim_u else d.U,
                               count=torch.clamp(d.count + n, max=d.capacity))


def _shift_in(buf, col, discount: float):
    """Append a column on the right, discounting history, dropping the
    oldest column."""
    out = torch.roll(buf * discount, -1, dims=-1)
    out[..., -1] = col.reshape(buf.shape[:-1]).to(buf.dtype)
    return out


def discrep_fit_iteration(d: DiscrepDMDc, next_y, next_x, next_u) -> DiscrepDMDc:
    """Streaming discrepancy update: append the snapshot, then, where the
    state history has rank >= dim_x, add the correction
    A += (Y - A Z) pinv(Z, rcond). The rank gate is a per-lane `where`."""
    Y = _shift_in(d.Y, next_y, d.discount)
    X = _shift_in(d.X, next_x, d.discount)
    U = _shift_in(d.U, next_u, d.discount) if d.dim_u else d.U
    count = torch.clamp(d.count + 1, max=d.capacity)
    Z = torch.cat([X, U], dim=-2)
    # a lane whose history went non-finite gets NaN singular values (and
    # no correction), as in the reference, not an error for the batch
    finite = torch.isfinite(X).all(dim=-1).all(dim=-1)[..., None]
    svals = torch.where(finite, torch.linalg.svdvals(torch.where(finite[..., None], X, 0.0)),
                        float("nan"))
    tol = svals.amax(dim=-1, keepdim=True) * max(X.shape[-2:]) * torch.finfo(svals.dtype).eps
    rank = (svals > tol).sum(dim=-1)
    A_x, A_u = get_discrete(d)
    resid = Y - (cx_mm(A_x, X) + cx_mm(A_u, U))
    A1 = resid @ pinv(Z, d.rcond).to(resid.dtype)
    gate = (rank >= d.min_rank)[..., None, None]
    return dataclasses.replace(d, A=torch.where(gate, d.A + A1, d.A), Y=Y, X=X, U=U,
                               count=count)


# ---------------------------------------------------------------------------
# Online (RLS) DMDc
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OnlineDMDc:
    """Recursive-least-squares DMDc."""

    A: torch.Tensor  # (..., dim_y, dim_z)
    P: torch.Tensor  # (..., dim_z, dim_z) inverse-covariance proxy
    dim_y: int = static()
    dim_x: int = static()
    dim_u: int = static()
    discount: float = static(1.0)


def online_from_data(Y, X, U=None, discount: float = 1.0) -> OnlineDMDc:
    """Batch initialization P0 = pinv(Z Z^T), A0 = Y Z^T P0 (plain
    transposes, the RLS convention). Assumes full-rank data."""
    Z = _stack_z(X, U)
    Zt = Z.transpose(-1, -2)
    P0 = pinv(Z @ Zt)
    return OnlineDMDc(A=Y @ Zt @ P0, P=P0, dim_y=Y.shape[-2], dim_x=X.shape[-2],
                      dim_u=0 if U is None else U.shape[-2], discount=discount)


def online_from_bootstrap(A0, dim_y: int, dim_x: int, dim_u: int, alpha: float = 1e2,
                          discount: float = 1.0) -> OnlineDMDc:
    """P0 = alpha I (one per lane when A0 carries a lane axis)."""
    dim_z = dim_x + dim_u
    eye = torch.eye(dim_z, dtype=A0.dtype, device=A0.device)
    P0 = (alpha * eye).expand(A0.shape[:-2] + (dim_z, dim_z)).clone()
    return OnlineDMDc(A=A0, P=P0, dim_y=dim_y, dim_x=dim_x, dim_u=dim_u, discount=discount)


def online_from_randn(generator: torch.Generator, dim_y: int, dim_x: int, dim_u: int,
                      sigma: float = 1.0, alpha: float = 1e2, discount: float = 1.0,
                      dtype=torch.float64, device=None) -> OnlineDMDc:
    """Random-normal bootstrap, drawn by `generator`."""
    device = generator.device if device is None else device
    A0 = sigma * torch.randn((dim_y, dim_x + dim_u), generator=generator, dtype=torch.float64,
                             device=device).to(dtype)
    return online_from_bootstrap(A0, dim_y, dim_x, dim_u, alpha=alpha, discount=discount)


def online_fit_iteration(m: OnlineDMDc, next_y, next_x, next_u) -> OnlineDMDc:
    """Rank-1 RLS update:
        gamma = 1 / (1 + z^T P z);  A += gamma (y - A z) (P z)^T;
        P = (P - gamma (P z)(P z)^T) / discount.
    """
    dt = m.A.dtype
    y = next_y.reshape(m.A.shape[:-1]).to(dt)
    lead = m.A.shape[:-2]
    z = torch.cat([next_x.reshape(lead + (-1,)).to(dt), next_u.reshape(lead + (-1,)).to(dt)],
                  dim=-1)
    Az = (m.A @ z[..., None])[..., 0]
    Pz = (m.P @ z[..., None])[..., 0]
    gamma = 1.0 / (1.0 + (z * Pz).sum(dim=-1))
    g = gamma[..., None, None]
    A_new = m.A + g * ((y - Az)[..., :, None] * Pz[..., None, :])
    P_new = (m.P - g * (Pz[..., :, None] * Pz[..., None, :])) / m.discount
    return dataclasses.replace(m, A=A_new, P=P_new)


# ---------------------------------------------------------------------------
# Snapshot history
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HistoryState:
    """A model wrapped with a fixed-capacity ring of `A` snapshots (and of
    `P` snapshots when the model has an RLS state): `buf[0]` holds the
    initial operator for good, writes k = 1, 2, ... go to slot
    1 + (k - 1) % (n_slots - 1), one every `every` updates."""

    inner: object                  # the wrapped model (exposes .A)
    buf: torch.Tensor              # (..., n_slots, dim_y, dim_z)
    n_recorded: torch.Tensor       # (...,) int32: snapshots taken (may exceed n_slots)
    it: torch.Tensor               # (...,) int32: updates seen
    pbuf: Optional[torch.Tensor] = None  # (..., n_slots, dim_z, dim_z) or None
    every: int = static(10)

    @property
    def A(self):
        return self.inner.A


def with_history(model_state, n_slots: int, every: int = 10) -> HistoryState:
    """Wrap a model so that streaming updates (`history_update`) record
    snapshots."""
    if n_slots < 2:
        raise ValueError(
            f"n_slots={n_slots}: need >= 2 (slot 0 permanently holds A0, the "
            "remaining slots ring the cadenced snapshots - with one slot the "
            "ring is empty and the slot arithmetic divides by zero)")

    def ring0(M0):
        buf = torch.zeros(M0.shape[:-2] + (n_slots,) + M0.shape[-2:], dtype=M0.dtype,
                          device=M0.device)
        buf[..., 0, :, :] = M0
        return buf

    A0 = model_state.A
    lead = A0.shape[:-2]
    counter = lambda v: torch.full(lead, v, dtype=torch.int32, device=A0.device)
    P = getattr(model_state, "P", None)
    return HistoryState(inner=model_state, buf=ring0(A0), n_recorded=counter(1), it=counter(0),
                        pbuf=None if P is None else ring0(P), every=every)


def history_update(update_fn: Callable) -> Callable:
    """Lift a model update (state, y, x, u) -> state to HistoryState."""

    def fn(h: HistoryState, next_y, next_x, next_u) -> HistoryState:
        inner = update_fn(h.inner, next_y, next_x, next_u)
        it = h.it + 1
        take = (it % h.every) == 0
        n_slots = h.buf.shape[-3]
        slot = 1 + torch.remainder(h.n_recorded - 1, n_slots - 1)
        ar = torch.arange(n_slots, device=slot.device)
        sel = (take[..., None] & (ar == slot[..., None]))[..., None, None]

        def write(buf, M):
            return torch.where(sel, M[..., None, :, :].to(buf.dtype), buf)

        pbuf = write(h.pbuf, inner.P) if h.pbuf is not None else None
        return dataclasses.replace(h, inner=inner, buf=write(h.buf, inner.A), pbuf=pbuf, it=it,
                                   n_recorded=h.n_recorded + take.to(torch.int32))

    return fn


def _ring_read(buf, n: int):
    """The surviving writes of a slot-0-pinned ring, oldest first."""
    buf = buf.detach().cpu().numpy()
    n_slots = buf.shape[0]
    if n <= n_slots:
        return [buf[i] for i in range(n)]
    ks = range(n - (n_slots - 1), n)
    return [buf[0]] + [buf[1 + (k - 1) % (n_slots - 1)] for k in ks]


def history_snapshots(h: HistoryState):
    """Host side, one model: the recorded `A` snapshots, oldest first (numpy
    list). Once the ring wrapped the oldest are gone; buf[0] (A0) stays."""
    return _ring_read(h.buf, int(h.n_recorded))


def history_p_snapshots(h: HistoryState):
    """Host side, one model: the recorded RLS `P` snapshots, as
    `history_snapshots`."""
    if h.pbuf is None:
        raise ValueError("wrapped model has no RLS state P (pbuf is None); "
                         "P history exists only for OnlineDMDc-style models")
    return _ring_read(h.pbuf, int(h.n_recorded))


def models_to(model, device=None, dtype: Optional[torch.dtype] = None):
    """Move a model's tensors; `dtype` is the real dtype (complex fields take
    its complex partner, integer fields keep theirs)."""
    cdtype = None if dtype is None else (torch.complex128 if dtype == torch.float64
                                         else torch.complex64)

    def move(t):
        if t.is_complex():
            return t.to(device, cdtype)
        if t.is_floating_point():
            return t.to(device, dtype)
        return t.to(device)
    return tree_map(move, model)

