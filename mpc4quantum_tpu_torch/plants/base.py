"""The surface every plant kind gives the fleet runner (quantum, synthesis,
Lindblad): lane batches of tensors, moved and sliced field by field, a
lift and a projection (the identity unless a plant kind says otherwise), a
batched exact step and a norm bound.

Every field of a plant is a tensor, except those declared with
`static_field`: settings shared by every lane (the quantum plant's
measurement adapter), which moving, slicing and batching leave as they are.
An optional tensor field may be None (the quantum plant's observation map);
the walkers leave it None.
Complex fields carry the state's dtype, real fields (sigma) its real
partner. A lane batch carries a leading axis B on every tensor field; the
first field is always complex and sets the batch size, the device and the
dtypes.

Each plant kind provides
  step(x, u, dt, taylor_k, max_squarings): one exact ZOH step per lane, its
      propagator taken by one `expm_small` launch;
  norm_bound(dt, sat): the worst-case 1-norm of dt times the step's
      generator over the control box |u| <= sat and every lane, which sizes
      the expm budget (benchfleet.expm_budget_for).
"""

from __future__ import annotations

import dataclasses

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


class Plant:
    """Base of the plant dataclasses."""

    def tensor_fields(self) -> dict:
        """The tensor fields by name; static fields and optional tensor
        fields that are None (the quantum plant's e_ops) are left out, so
        the walkers below keep them as they are."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if not f.metadata.get("static") and getattr(self, f.name) is not None}

    def to(self, device=None, dtype=None):
        """Move to a device; `dtype` is the real dtype (float32/float64)."""
        cdtype = None if dtype is None else complex_dtype(dtype)
        return dataclasses.replace(self, **{
            k: t.to(device, cdtype if t.is_complex() else dtype)
            for k, t in self.tensor_fields().items()})

    def __getitem__(self, idx):
        """Lane slice of a batch (`plant[None]`: a one-lane batch of a
        single plant)."""
        return dataclasses.replace(self, **{k: t[idx] for k, t in self.tensor_fields().items()})

    @property
    def _lead(self) -> torch.Tensor:
        return getattr(self, dataclasses.fields(self)[0].name)

    @property
    def lanes(self) -> int:
        """B of a lane batch."""
        return self._lead.shape[0]

    @property
    def device(self) -> torch.device:
        return self._lead.device

    @property
    def dtype(self) -> torch.dtype:
        """The complex dtype of the state."""
        return self._lead.dtype

    @property
    def real_dtype(self) -> torch.dtype:
        return self._lead.dtype.to_real()

    def lift(self, x: torch.Tensor) -> torch.Tensor:
        """Experiment state (B, dim_e) -> model space (B, dim_x): the
        identity adapter."""
        return x

    def proj(self, z: torch.Tensor) -> torch.Tensor:
        """Model space (B, dim_x) -> experiment state (B, dim_e): the
        identity adapter."""
        return z
