"""Lane batches of perturbed plants (counterpart of
mpc4quantum_tpu/parallel/fleet.py `make_scenario_batch`)."""

from __future__ import annotations

from typing import Optional

import torch

from ..plants.quantum import QuantumPlant


def make_scenario_batch(base_plant: QuantumPlant, n: int, detune_scale: float = 0.01,
                        generator: Optional[torch.Generator] = None,
                        device=None, dtype: torch.dtype = torch.float64) -> QuantumPlant:
    """n plants with drift H0 (1 + eps), eps ~ N(0, detune_scale^2); the
    drive is left as it is.

    The draws are made in float64 by a CPU generator and only then moved to
    `device` in `dtype` (the real dtype), so one seed gives the same plants
    on the CPU and on the card. `torch.Generator` and `jax.random` give
    different numbers from one seed; parity tests pass JAX-drawn plants in.
    """
    generator = generator if generator is not None else torch.Generator().manual_seed(1)
    eps = detune_scale * torch.randn(n, generator=generator, dtype=torch.float64)
    H0 = base_plant.H0.to("cpu", torch.complex128)
    H1s = base_plant.H1s.to("cpu", torch.complex128)
    batch = QuantumPlant(
        H0=H0 * (1.0 + eps)[:, None, None],
        H1s=H1s.expand(n, -1, -1, -1).clone(),
        sigma=base_plant.sigma.to("cpu", torch.float64).expand(n).clone(),
    )
    return batch.to(device, dtype)
