"""PyTorch/CUDA port of mpc4quantum_tpu for NVIDIA Hopper.

Model predictive control of quantum state preparation, batched over fleets
of perturbed plants. The modules mirror the JAX package (`ops/`,
`solvers/`, `plants/`, `models/`, `mpc/`, `parallel/`, `presets.py`,
`benchfleet.py`); the box-QP solve and the plant expm run as hand-written
CUDA kernels (`kernels/`, sources in `csrc/`) on the card and as their plain
PyTorch versions on the CPU. This package never imports JAX.

Quick start, on the card (float32):

    from mpc4quantum_tpu_torch import presets, run_hostloop_fleet
    sc = presets.not_state()
    metrics, out = run_hostloop_fleet(sc, batch=16384, reps=4)

On the CPU, through the kernels' plain versions: presets.not_state(device="cpu")
(float64 there). The seven presets are in presets.PRESETS; `rescue=` of
run_hostloop_fleet re-runs the marginal lanes under a second scenario.
"""

from . import presets
from .benchfleet import rescue_pass, run_hostloop_fleet

__all__ = ["presets", "rescue_pass", "run_hostloop_fleet"]
