"""Lane batches of perturbed plants and batched rollouts (counterpart of
mpc4quantum_tpu/parallel/fleet.py `make_scenario_batch`, `batched_mpc` and
`fleet_summary`; `batched_mpc` is the fleet runner's, mpc/fleet_runner.py;
the sharded forms wait for the multi-device layer)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..mpc.driver import MPCResult
from ..mpc.fleet_runner import batched_mpc
from ..plants.base import Plant

__all__ = ["make_scenario_batch", "batched_mpc", "fleet_summary"]


def make_scenario_batch(base_plant: Plant, n: int, detune_scale: float = 0.01,
                        generator: Optional[torch.Generator] = None,
                        device=None, dtype: Optional[torch.dtype] = None) -> Plant:
    """n plants with the kind's drift field (`Plant.drift`) scaled by
    (1 + eps), eps ~ N(0, detune_scale^2): H0 of a quantum or synthesis
    plant, AH0 of a Lindblad plant, whose dissipator AD stays physical, a
    classical plant's parameter; a wrapper (the real-embedded plant) passes
    the draw to the plant it wraps. The drive is left as it is.

    The draws are made in float64 by a CPU generator and only then moved to
    `device` in `dtype` (the real dtype; by default the base plant's device
    and dtype), so one seed gives the same plants on the CPU and on the
    card. `torch.Generator` and `jax.random` give different numbers from
    one seed; parity tests pass JAX-drawn plants in.
    """
    generator = generator if generator is not None else torch.Generator().manual_seed(1)
    eps = detune_scale * torch.randn(n, generator=generator, dtype=torch.float64)

    def lanes(t: torch.Tensor) -> torch.Tensor:
        t = t.to("cpu", torch.complex128 if t.is_complex() else torch.float64)
        return t.expand(n, *t.shape).clone()

    def batch(plant: Plant) -> Plant:
        # the tensor fields; a plant's settings (its measurement adapter) carry over
        fields = {name: batch(t) if isinstance(t, Plant) else lanes(t)
                  for name, t in plant.tensor_fields().items()}
        if plant.drift is not None:
            t = fields[plant.drift]
            fields[plant.drift] = t * (1.0 + eps).reshape((n,) + (1,) * (t.dim() - 1))
        return dataclasses.replace(plant, **fields)

    return batch(base_plant).to(base_plant.device if device is None else device,
                                base_plant.real_dtype if dtype is None else dtype)


def fleet_summary(result: MPCResult, target) -> dict:
    """The batch's summary scalars: fidelity Re <target, x_final> (mean and
    min), the completed fraction (exit code 0 or 1) and the mean SQP
    iterations a step, as 0-dim tensors on the result's device.

    :param target: (dim_e,) target state.
    """
    xf = result.xs[..., -1]
    target = torch.as_tensor(target).to(xf.device, xf.dtype)
    fid = (xf * target.conj()).sum(dim=-1).real
    ok = (result.exit_code == 0) | (result.exit_code == 1)
    return {"fidelity_mean": fid.mean(), "fidelity_min": fid.min(),
            "completed_frac": ok.float().mean(),
            "sqp_iters_mean": result.sqp_iters.float().mean()}
