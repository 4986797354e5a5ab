"""The real-embedded problem (counterpart of mpc4quantum_tpu/mpc/embedded.py):
the whole MPC problem in R^{2n} instead of C^n.

    vec(rho) in C^n          ->  [Re x; Im x] in R^{2n}
    A (m, n) complex         ->  [[Re A, -Im A], [Im A, Re A]] (2m, 2n) real
    Re <e, Q e> (Hermitian Q) ==  e_r^T Q_emb e_r      (exact)

The model, the targets, the costs and the states are embedded; the control
library is real, so the stacked bilinear operator embeds block by block.
The plant stays complex inside `EmbeddedPlant`, a Plant whose step,
lift and projection unembed, call the wrapped plant (its step is one
`expm_small` launch) and embed again; the loop sees only real vectors. The
closed loop is the complex one's, up to rounding: the embedding is an
algebra isomorphism. Streaming refits are refused on an embedded plant: an
embedded refit would not keep the operator complex-linear.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from ..plants.base import Plant
from ..utils.linalg import complex_to_real_op


def embed_vec(x: torch.Tensor) -> torch.Tensor:
    """C^n -> R^2n along the last axis: [Re x; Im x]."""
    x = torch.as_tensor(x)
    im = x.imag if x.is_complex() else torch.zeros_like(x)
    return torch.cat([x.real, im], dim=-1)


def unembed_vec(z: torch.Tensor) -> torch.Tensor:
    """R^2n -> C^n along the last axis."""
    n = z.shape[-1] // 2
    return torch.complex(z[..., :n], z[..., n:])


def embed_op(A: torch.Tensor) -> torch.Tensor:
    """C^(m, n) -> R^(2m, 2n): [[Re, -Im], [Im, Re]]."""
    return complex_to_real_op(A)


def embed_stacked_model(A_stacked: torch.Tensor, dim_x: int) -> torch.Tensor:
    """Embed a stacked DMDc / bilinear operator [A | N_1 | N_2 | ...]: each
    (dim_x, dim_x) block on its own (the monomials f(u) are real, so the
    Khatri-Rao structure survives exactly).

    :param A_stacked: (dim_x, dim_x L) complex.
    :return: (2 dim_x, 2 dim_x L) real.
    """
    L = A_stacked.shape[-1] // dim_x
    return torch.cat([embed_op(A_stacked[..., l * dim_x:(l + 1) * dim_x]) for l in range(L)],
                     dim=-1)


def embed_cost(Q: torch.Tensor) -> torch.Tensor:
    """Hermitian Q -> real symmetric Q_emb with Re <e, Q e> = e_r^T Q_emb e_r."""
    return embed_op(Q)


@dataclasses.dataclass(frozen=True)
class EmbeddedPlant(Plant):
    """A plant observed and driven in the real embedding of its complex
    state. Lane batches, devices and dtypes are the wrapped plant's; the
    state is real, of twice its dimension. Measurement noise (the runner's
    default observation, x + sigma noise) is real Gaussian of scale sigma
    on the embedded vector: complex Gaussian of scale sigma on the state."""

    base: Plant

    real_state = True
    drift = None
    streaming_ok = False

    @property
    def uses_expm(self) -> bool:
        return self.base.uses_expm

    @property
    def sigma(self) -> Optional[torch.Tensor]:
        return getattr(self.base, "sigma", None)

    @property
    def n_obs(self) -> int:
        """An observation is the embedded vector: 2 n_obs of the plant."""
        return 2 * self.base.n_obs

    def lift(self, xe: torch.Tensor) -> torch.Tensor:
        return embed_vec(self.base.lift(unembed_vec(xe)))

    def proj(self, ze: torch.Tensor) -> torch.Tensor:
        return embed_vec(self.base.proj(unembed_vec(ze)))

    def step(self, xe, u, dt: float, taylor_k: int, max_squarings: int) -> torch.Tensor:
        return embed_vec(self.base.step(unembed_vec(xe), u, dt, taylor_k, max_squarings))

    def norm_bound(self, dt: float, sat) -> float:
        return self.base.norm_bound(dt, sat)


class EmbeddedProblem(NamedTuple):
    x0: torch.Tensor       # (2 dim_e,) real
    model_A: torch.Tensor  # (2 dim_x, 2 dim_x L) real
    X_targ: torch.Tensor   # (2 dim_x, T) real
    Q: torch.Tensor        # (2 dim_x, 2 dim_x) real symmetric
    Qf: torch.Tensor
    plant: Optional[EmbeddedPlant]  # the wrapped plant, where one was given


def embed_problem(x0, model_A, X_targ, Q, Qf, dim_x: int, plant: Optional[Plant] = None,
                  observe_fn: Optional[Callable] = None):
    """The real-embedded problem data and plant.

    :param x0: (dim_e,) complex; model_A (dim_x, dim_x L); X_targ
        (dim_x, T); Q, Qf (dim_x, dim_x) Hermitian; all tensors.
    :param dim_x: the model space's complex dimension.
    :param plant: the complex plant (one, or a lane batch) to wrap in
        EmbeddedPlant; None leaves EmbeddedProblem.plant None.
    :param observe_fn: None, or the complex loop's observation
        (plants, x, noise) -> x_measured (e.g. plants.quantum.quantum_observe).
    :return: (EmbeddedProblem, observe_emb): observe_emb is None where the
        runner's default observation (x + sigma noise, real noise on the
        embedded vector) is the embedded one, else the runner's observe_fn:
        it unembeds the state and the noise (2 n_obs real draws), observes
        through observe_fn on the wrapped plant and embeds the result.
    """
    observe_emb = None
    if observe_fn is not None:
        def observe_emb(plants: EmbeddedPlant, xe, noise=None):
            z = None if noise is None else unembed_vec(noise)
            return embed_vec(observe_fn(plants.base, unembed_vec(xe), z))
    prob = EmbeddedProblem(
        x0=embed_vec(x0), model_A=embed_stacked_model(model_A, dim_x),
        X_targ=embed_vec(X_targ.T).T, Q=embed_cost(Q), Qf=embed_cost(Qf),
        plant=None if plant is None else EmbeddedPlant(plant))
    return prob, observe_emb
