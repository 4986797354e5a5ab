"""The surface every plant kind gives the fleet runner (quantum, synthesis,
Lindblad, classical and the real-embedded wrapper): lane batches of
tensors, moved and sliced field by field, a lift and a projection (the
identity unless a plant kind says otherwise), a batched step and, for the
kinds that step by an expm, a norm bound.

Every field of a plant is a tensor or a wrapped plant, except those
declared with `static_field`: settings shared by every lane (the quantum
plant's measurement adapter, the classical plant's right-hand side), which
moving, slicing and batching leave as they are. An optional tensor field
may be None (the quantum plant's observation map); the walkers leave it
None. A wrapped plant is moved and sliced as a whole.
A lane batch carries a leading axis B on every tensor field; the first
field (or the first field of the plant it wraps) sets the batch size, the
device and the real dtype. The state is complex (the partner of that real
dtype) unless the kind declares `real_state`; complex fields carry the
complex dtype, real fields (sigma, a classical plant's parameter) the real
one.

Each plant kind provides
  step(x, u, dt, taylor_k, max_squarings): one ZOH step per lane; the
      quantum kinds take their propagator from one `expm_small` launch at
      that budget, the classical kind integrates by RK4 and ignores it;
  norm_bound(dt, sat) where `uses_expm`: the worst-case 1-norm of dt times
      the step's generator over the control box |u| <= sat and every lane,
      which sizes the expm budget (benchfleet.expm_budget_for); a kind
      without an expm raises;
  drift: the name of the field that make_scenario_batch detunes (None: the
      kind has none of its own; a wrapped plant's is detuned).
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import numpy as np
import torch


def static_field(default):
    """A dataclass field that is a setting, not a per-lane tensor."""
    return dataclasses.field(default=default, metadata={"static": True})


def default_dtype(device, dtype=None) -> torch.dtype:
    """The real dtype of tensors built on `device`: `dtype` where given,
    else float32 on a CUDA device (the runner on the card takes float32
    only) and float64 elsewhere."""
    if dtype is not None:
        return dtype
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64


def complex_dtype(real_dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if real_dtype == torch.float64 else torch.complex64


def box_norm_bound(G0: torch.Tensor, G1s: torch.Tensor, dt: float, sat) -> float:
    """Worst-case ||dt (G0 + sum_i u_i G1_i)||_1 over |u_i| <= sat_i, by the
    triangle inequality, over every lane of a batch (host side, float64).

    :param G0: (..., m, m) drift; :param G1s: (..., dim_u, m, m) controls.
    """
    one_norm = lambda M: float(np.max(np.sum(np.abs(M), axis=-2)))
    G0 = G0.detach().cpu().numpy()
    G1s = G1s.detach().cpu().numpy()
    sat_v = np.broadcast_to(np.asarray(sat, float), (G1s.shape[-3],))
    return abs(float(dt)) * (one_norm(G0) + sum(s * one_norm(G1s[..., k, :, :])
                                                 for k, s in enumerate(sat_v)))


def generator_at(G0: torch.Tensor, G1s: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """G0 + sum_i u_i G1_i for one plant (G1s (dim_u, m, m), u (dim_u,)) or
    a lane batch (G1s (B, dim_u, m, m), u (B, dim_u)): (..., m, m)."""
    u = u.reshape(G1s.shape[:-2]).to(G1s.dtype)
    return G0 + torch.sum(u[..., None, None] * G1s, dim=-3)


class Plant:
    """Base of the plant dataclasses."""

    # the state is real (classical ODEs, the real embedding), not complex
    real_state: ClassVar[bool] = False
    # the step takes its propagator from the expm kernel, sized by norm_bound
    uses_expm: ClassVar[bool] = True
    # the field make_scenario_batch detunes by (1 + eps)
    drift: ClassVar[Optional[str]] = "H0"
    # a fleet may refit its model online on this kind's states
    streaming_ok: ClassVar[bool] = True

    def tensor_fields(self) -> dict:
        """The tensor and wrapped-plant fields by name; static fields and
        optional tensor fields that are None (the quantum plant's e_ops) are
        left out, so the walkers below keep them as they are."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if not f.metadata.get("static") and getattr(self, f.name) is not None}

    def to(self, device=None, dtype=None):
        """Move to a device; `dtype` is the real dtype (float32/float64)."""
        cdtype = None if dtype is None else complex_dtype(dtype)

        def move(t):
            if isinstance(t, Plant):
                return t.to(device, dtype)
            return t.to(device, cdtype if t.is_complex() else dtype)
        return dataclasses.replace(self, **{k: move(t) for k, t in self.tensor_fields().items()})

    def __getitem__(self, idx):
        """Lane slice of a batch (`plant[None]`: a one-lane batch of a
        single plant)."""
        return dataclasses.replace(self, **{k: t[idx] for k, t in self.tensor_fields().items()})

    @property
    def _lead(self) -> torch.Tensor:
        lead = getattr(self, dataclasses.fields(self)[0].name)
        return lead._lead if isinstance(lead, Plant) else lead

    @property
    def lanes(self) -> int:
        """B of a lane batch."""
        return self._lead.shape[0]

    @property
    def device(self) -> torch.device:
        return self._lead.device

    @property
    def dtype(self) -> torch.dtype:
        """The dtype of the state: the real dtype where `real_state`, else
        its complex partner."""
        return self.real_dtype if self.real_state else complex_dtype(self.real_dtype)

    @property
    def real_dtype(self) -> torch.dtype:
        return self._lead.dtype.to_real()

    def norm_bound(self, dt: float, sat) -> float:
        """The expm budget's norm bound (the kinds with an expm override
        this)."""
        raise ValueError(f"{type(self).__name__} steps without an expm and has no expm "
                         "budget or norm bound")

    def lift(self, x: torch.Tensor) -> torch.Tensor:
        """Experiment state (B, dim_e) -> model space (B, dim_x): the
        identity adapter."""
        return x

    def proj(self, z: torch.Tensor) -> torch.Tensor:
        """Model space (B, dim_x) -> experiment state (B, dim_e): the
        identity adapter."""
        return z
