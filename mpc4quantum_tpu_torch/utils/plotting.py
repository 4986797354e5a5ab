"""Diagnostic plots of models and rollouts (counterpart of
mpc4quantum_tpu/utils/plotting.py): the stacked operator's blocks as symlog
real / imaginary panels, and a rollout's pulses, populations and
log-infidelity.

matplotlib is imported when a function is called, with the Agg backend, so
the package does not need it; each function takes tensors (on any device)
or numpy arrays, and writes a PNG where it is given a path.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(a):
    """A tensor (any device) or array-like as a numpy array."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _mpl():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return matplotlib, plt


def plot_operator(A, dim_x: int, linthresh: float = 1e-3, path: str | None = None):
    """Render the stacked bilinear operator as symlog real/imag panels.

    :param A: (dim_x, dim_x * L) stacked operator, one (dim_x, dim_x) block
        a control monomial (the model layout of models/dmdc.py).
    :param dim_x: state dimension; L = A.shape[1] // dim_x blocks.
    :param path: optional PNG output path.
    :return: (fig, axes).
    """
    mpl, plt = _mpl()
    A = _np(A)
    L = A.shape[1] // dim_x
    blocks = A.reshape(dim_x, L, dim_x).transpose(1, 0, 2)  # (L, dim_x, dim_x)

    norm = mpl.colors.SymLogNorm(vmin=-1, vmax=1, linthresh=linthresh)
    fig, axes = plt.subplots(2, L, figsize=(2.2 * L + 1.2, 4.4), squeeze=False)
    im = None
    for i in range(L):
        for r, part in enumerate((blocks[i].real, blocks[i].imag)):
            ax = axes[r, i]
            im = ax.imshow(part, norm=norm, cmap="RdBu_r")
            ax.set_xticks([])
            ax.set_yticks([])
        axes[0, i].set_title(f"block {i}", fontsize=8)
    axes[0, 0].set_ylabel("Re")
    axes[1, 0].set_ylabel("Im")
    fig.subplots_adjust(right=0.86, hspace=0.05)
    fig.colorbar(im, cax=fig.add_axes([0.89, 0.15, 0.03, 0.7]))
    if path is not None:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig, axes


def plot_rollout(ts, us, xs=None, targ=None, sat: float | None = None,
                 path: str | None = None):
    """Pulse + population + log-infidelity panels for one MPC rollout.

    :param ts: (n,) step times; :param us: (dim_u, n) applied controls.
    :param xs: optional (dim_e, n+1) state trajectory (vec(rho) columns).
    :param targ: optional (dim_e,) target state; adds the log-infidelity
        panel 1 - Re<targ, x_t>.
    :param sat: optional control bound, drawn as dashed guides.
    :param path: optional PNG output path.
    :return: (fig, axes).
    """
    _, plt = _mpl()
    ts = _np(ts)
    us = np.atleast_2d(_np(us))
    n_panels = 1 + (xs is not None) + (xs is not None and targ is not None)
    fig, axes = plt.subplots(n_panels, 1, figsize=(6.4, 2.4 * n_panels),
                             sharex=True, squeeze=False)
    axes = axes[:, 0]

    ax = axes[0]
    for i in range(us.shape[0]):
        ax.step(ts[: us.shape[1]], us[i], where="post", label=f"u{i + 1}")
    if sat is not None:
        ax.axhline(sat, ls="--", c="gray", lw=0.8)
        ax.axhline(-sat, ls="--", c="gray", lw=0.8)
    ax.set_ylabel("control")
    ax.legend(loc="upper right", fontsize=7)

    if xs is not None:
        xs = _np(xs)
        d = int(round(np.sqrt(xs.shape[0])))
        ax = axes[1]
        t_x = np.arange(xs.shape[1]) * (ts[1] - ts[0] if len(ts) > 1 else 1.0) + ts[0]
        for k in range(d):
            ax.plot(t_x, xs[k * d + k].real, label=f"P{k}")
        ax.set_ylabel("populations")
        ax.legend(loc="upper right", fontsize=7)

        if targ is not None:
            targ = _np(targ)
            fid = np.clip(np.real(np.conj(targ) @ xs), 0.0, 1.0)
            ax = axes[2]
            ax.semilogy(t_x, np.maximum(1.0 - fid, 1e-16))
            ax.set_ylabel("1 - fidelity")
    axes[-1].set_xlabel("t")
    if path is not None:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig, axes
