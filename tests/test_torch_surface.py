"""The port's single-call functions against their JAX namesakes on the CPU:
the Pade expm and the exported propagators, the one-point bilinear forms,
the quantum, Lindblad and synthesis plants' free functions (lift, proj, the
Pade and Taylor steps, simulate), the plots, and the driver's model seam
left open (model_fns=None) against the dense contractions passed through it.

The same seeded numpy inputs go through both packages, JAX in x64 (set by
conftest.py) and the port in float64. Tolerances: 1e-12 where both run the
same algorithm on values of order one (the Pade expm, the bilinear forms,
the adapters, the Pade steps); 1e-10 where the port's Taylor form (one
`expm_small` call, its plain version here) stands beside JAX's Taylor or
Pade form (truncation 1/17! at order 16, ~1e-12 at Taylor 12 within its
budget); the plots' drawn data exactly. The fleet through the seam is
`torch.equal` to the fleet without it.
"""

import dataclasses

import matplotlib
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mpc4quantum_tpu.ops import bilinear as jbil
from mpc4quantum_tpu.ops import expm as jexpm
from mpc4quantum_tpu.ops.liouville import lindblad_generator as j_lindblad_generator
from mpc4quantum_tpu.plants import lindblad as jlin, quantum as jq, synthesis as jsyn
from mpc4quantum_tpu.utils import plotting as jplot

import mpc4quantum_tpu_torch as port
from mpc4quantum_tpu_torch import presets as tpresets
from mpc4quantum_tpu_torch.benchfleet import make_runner
from mpc4quantum_tpu_torch.convert import operator_rows
from mpc4quantum_tpu_torch.models.dmdc import predict as t_predict
from mpc4quantum_tpu_torch.mpc.driver import ModelApplyFns
from mpc4quantum_tpu_torch.ops import bilinear as tbil
from mpc4quantum_tpu_torch.ops.library import size_of_library
from mpc4quantum_tpu_torch.plants import lindblad as tlin, synthesis as tsyn
from mpc4quantum_tpu_torch.utils import plotting as tplot

EXACT = 1e-12
TAYLOR = 1e-10

SX = np.array([[0, 1], [1, 0]], complex)


def close(t, j, tol=EXACT):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=0, atol=tol)


def crandn(rng, *shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def hermitian(rng, d):
    G = crandn(rng, d, d)
    return 0.5 * (G + G.conj().T)


def density(rng, d):
    G = crandn(rng, d, d)
    rho = G @ G.conj().T
    return rho / np.trace(rho)


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("scale", [0.3, 6.0, 300.0])
def test_expm_pade_matches_jax(d, scale):
    """Complex and real batches across the no-squaring and squaring
    branches (theta_13 = 5.37), relative to the largest entry."""
    rng = np.random.default_rng(d * 7 + int(scale))
    A = crandn(rng, 5, d, d)
    A *= scale / np.abs(A).sum(axis=1).max(axis=1)[:, None, None]
    Er = rng.normal(size=(3, d, d)) * scale / d
    for M in (A, Er, A[0]):
        ref = np.asarray(jexpm.expm_pade(jnp.asarray(M)))
        out = port.expm_pade(torch.tensor(M))
        close(out / np.abs(ref).max(), ref / np.abs(ref).max())


def test_propagators_from_controls_match_jax():
    """The exported name: one expm_small call at the controls' Taylor
    budget (the plain version on the CPU) against JAX's Pade propagators,
    for Hamiltonians and for a Liouvillian generator."""
    rng = np.random.default_rng(3)
    H0, H1s = hermitian(rng, 4), np.stack([hermitian(rng, 4), hermitian(rng, 4)])
    us = rng.uniform(-1, 1, size=(2, 9))
    close(port.propagators_from_controls(torch.tensor(H0), torch.tensor(H1s), torch.tensor(us),
                                         0.4),
          jexpm.propagators_from_controls(H0, H1s, us, 0.4), TAYLOR)
    A0 = np.asarray(j_lindblad_generator(hermitian(rng, 2), [0.3 * crandn(rng, 2, 2)]))
    A1 = np.asarray(j_lindblad_generator(hermitian(rng, 2)))[None]
    close(port.propagators_from_controls(torch.tensor(A0), torch.tensor(A1),
                                         torch.tensor(us[:1]), 0.5, hermitian_generator=False),
          jexpm.propagators_from_controls(A0, A1, us[:1], 0.5, hermitian_generator=False),
          TAYLOR)


@pytest.mark.parametrize("order,dim_u", [(1, 1), (2, 2), (3, 2)])
def test_bilinear_point_forms_match_jax(order, dim_u):
    rng = np.random.default_rng(order * 10 + dim_u)
    dim_x = 5
    Lm = size_of_library(order, dim_u) - 1
    A, N = 0.3 * crandn(rng, dim_x, dim_x), 0.3 * crandn(rng, dim_x, dim_x * Lm)
    jm = jbil.BilinearModel.from_stacked(jnp.asarray(A), jnp.asarray(N), dim_u, order)
    tm = tbil.BilinearModel.from_stacked(torch.tensor(A), torch.tensor(N), dim_u, order)
    x, u = crandn(rng, dim_x), rng.normal(size=dim_u)
    X, U = crandn(rng, dim_x, 4), rng.normal(size=(dim_u, 4))
    tx, tu = torch.tensor(x), torch.tensor(u)
    close(tbil.bilinear_f(tm, tx, tu), jbil.bilinear_f(jm, jnp.asarray(x), jnp.asarray(u)))
    close(tbil.bilinear_df_dx(tm, tu), jbil.bilinear_df_dx(jm, jnp.asarray(u)))
    close(tbil.bilinear_df_du(tm, tx, tu), jbil.bilinear_df_du(jm, jnp.asarray(x), jnp.asarray(u)))
    for t, j in zip(port.model_from_initial(tm, torch.tensor(X), torch.tensor(U)),
                    jbil.model_from_initial(jm, jnp.asarray(X), jnp.asarray(U))):
        assert tuple(t.shape) == j.shape
        close(t, j)


def test_row_block_model_gives_those_rows():
    """A block of the operator's rows linearizes to those rows of the
    whole operator's (A_s, B_s, Delta_s), exactly (the tensor-parallel
    layer's building block); convert.operator_rows cuts the block."""
    rng = np.random.default_rng(11)
    dim_x, dim_u, order, H, B = 8, 2, 2, 3, 2
    L = size_of_library(order, dim_u)
    Afull = torch.tensor(0.3 * crandn(rng, dim_x, dim_x * L))
    X, U = torch.tensor(crandn(rng, B, dim_x, H)), torch.tensor(rng.normal(size=(B, dim_u, H)))
    whole = tbil.model_along_traj(
        tbil.BilinearModel.from_stacked(Afull[:, :dim_x], Afull[:, dim_x:], dim_u, order), X, U)
    for rank in range(4):
        blk = operator_rows(Afull.numpy(), rank, 4, device="cpu")
        assert torch.equal(blk, Afull[2 * rank:2 * rank + 2])
        part = tbil.model_along_traj(
            tbil.BilinearModel.from_stacked(blk[:, :dim_x], blk[:, dim_x:], dim_u, order), X, U)
        for p, w in zip(part, whole):
            close(p, w[:, :, 2 * rank:2 * rank + 2])


def test_lift_kind_maps_onto_the_lift_field():
    assert [k.value for k in port.LiftKind] == [k.value for k in jq.LiftKind]
    plant = port.QuantumPlant.create(np.eye(3), [np.eye(3)], lift_kind=port.LiftKind.TRUNCATE,
                                     lift_dim=2, device="cpu")
    assert plant.lift_kind == "truncate" and isinstance(plant.lift_kind, str)
    assert port.LiftKind.PARTIAL_TRACE == "partial_trace"
    with pytest.raises(ValueError, match="lift_kind"):
        port.QuantumPlant.create(np.eye(2), [np.eye(2)], lift_kind="bogus", device="cpu")


@pytest.mark.parametrize("kind,dim", [("IDENTITY", 2), ("TRUNCATE", 3), ("PARTIAL_TRACE", 4)])
def test_lift_state_and_proj_state_match_jax(kind, dim):
    rng = np.random.default_rng(dim)
    H0 = hermitian(rng, dim)
    jp = jq.QuantumPlant.create(H0, [hermitian(rng, dim)], lift_kind=jq.LiftKind[kind],
                                lift_dim=2)
    tp = port.QuantumPlant.create(H0, [np.asarray(jp.H1s[0])], lift_kind=port.LiftKind[kind],
                                  lift_dim=2, device="cpu")
    x = density(rng, dim).flatten()
    z = np.asarray(jq.lift_state(jp, jnp.asarray(x)))
    close(port.lift_state(tp, torch.tensor(x)), z)
    close(port.proj_state(tp, torch.tensor(z)), jq.proj_state(jp, jnp.asarray(z)))


def test_quantum_step_matches_jax():
    """The Pade step on one plant and on a lane batch (JAX under vmap), at
    a generator norm that takes squarings."""
    rng = np.random.default_rng(5)
    H0, H1s = 3.0 * hermitian(rng, 3), np.stack([hermitian(rng, 3), hermitian(rng, 3)])
    jp = jq.QuantumPlant.create(H0, list(H1s))
    tp = port.QuantumPlant.create(H0, H1s, device="cpu")
    rho, u = density(rng, 3).flatten(), rng.uniform(-2, 2, size=2)
    close(port.quantum_step(tp, torch.tensor(rho), torch.tensor(u), 0.7),
          jq.quantum_step(jp, jnp.asarray(rho), jnp.asarray(u), 0.7))
    rhos = np.stack([density(rng, 3).flatten() for _ in range(3)])
    us = rng.uniform(-2, 2, size=(3, 2))
    ref = jax.vmap(lambda r, v: jq.quantum_step(jp, r, v, 0.7))(jnp.asarray(rhos), jnp.asarray(us))
    lanes = port.make_scenario_batch(tp, 3, detune_scale=0.0)
    close(port.quantum_step(lanes, torch.tensor(rhos), torch.tensor(us), 0.7), ref)


def lindblad_pair(rng):
    H0, H1 = hermitian(rng, 2), 0.5 * SX
    c_ops = [np.sqrt(0.05) * np.array([[0, 1], [0, 0]], complex)]
    jp = jlin.LindbladPlant.create(H0, [H1], c_ops=c_ops, sigma=0.0)
    tp = tlin.LindbladPlant.create(H0, [H1], c_ops=c_ops)
    return jp, tp


def test_lindblad_free_functions_match_jax():
    """The identity adapters, the Pade step, the Taylor step (one expm_small
    call against JAX's fixed-squaring Taylor) and a 12-step simulation (one
    expm_small call for the 12 propagators against JAX's Pade scan)."""
    rng = np.random.default_rng(7)
    jp, tp = lindblad_pair(rng)
    x, u = density(rng, 2).flatten(), rng.uniform(-1, 1, size=1)
    tx, tu = torch.tensor(x), torch.tensor(u)
    close(tlin.lindblad_lift(tp, tx), jlin.lindblad_lift(jp, jnp.asarray(x)))
    close(tlin.lindblad_proj(tp, tx), jlin.lindblad_proj(jp, jnp.asarray(x)))
    close(port.lindblad_step(tp, tx, tu, 0.8), jlin.lindblad_step(jp, jnp.asarray(x),
                                                                  jnp.asarray(u), 0.8))
    close(port.lindblad_step_taylor(tp, tx, tu, 0.8),
          jlin.lindblad_step_taylor(jp, jnp.asarray(x), jnp.asarray(u), 0.8), TAYLOR)
    us = rng.uniform(-1, 1, size=(1, 12))
    out = port.lindblad_simulate(tp, tx, torch.tensor(us), 0.8)
    assert tuple(out.shape) == (4, 13)
    close(out, jlin.lindblad_simulate(jp, jnp.asarray(x), jnp.asarray(us), 0.8), TAYLOR)


def test_lindblad_simulate_noise_is_sigma_scaled():
    rng = np.random.default_rng(8)
    _, tp = lindblad_pair(rng)
    tp = dataclasses.replace(tp, sigma=torch.tensor(1e-3, dtype=torch.float64))
    x, us = torch.tensor(density(rng, 2).flatten()), torch.tensor(rng.uniform(-1, 1, (1, 5)))
    noise = torch.tensor(crandn(rng, 4, 6))
    clean = port.lindblad_simulate(tp, x, us, 0.8)
    close(port.lindblad_simulate(tp, x, us, 0.8, noise=noise), clean + 1e-3 * noise)


def test_synthesis_free_functions_match_jax():
    """lift / proj of a process (proj up to the same global phase), the Pade
    and Taylor process steps, and a 10-step process simulation."""
    rng = np.random.default_rng(9)
    H0, H1 = 0.3 * hermitian(rng, 2), 0.5 * SX
    jp = jsyn.SynthesisPlant.create(H0, [H1])
    tp = tsyn.SynthesisPlant(H0=torch.tensor(H0), H1s=torch.tensor(H1[None]))
    U = np.asarray(jexpm.expm_pade(jnp.asarray(-1j * hermitian(rng, 2))))
    p = np.asarray(jsyn.lift_unitary(jnp.asarray(U.flatten())))
    close(port.lift_unitary(torch.tensor(U.flatten())), p)
    close(port.proj_process(torch.tensor(p)), jsyn.proj_process(jnp.asarray(p)))
    close(port.proj_process(torch.tensor(np.stack([p, p]))),
          np.stack([np.asarray(jsyn.proj_process(jnp.asarray(p)))] * 2))
    u = rng.uniform(-1, 1, size=1)
    close(tsyn.synthesis_step(tp, torch.tensor(p), torch.tensor(u), 0.6),
          jsyn.synthesis_step(jp, jnp.asarray(p), jnp.asarray(u), 0.6))
    close(tsyn.synthesis_step_taylor(tp, torch.tensor(p), torch.tensor(u), 0.6),
          jsyn.synthesis_step_taylor(jp, jnp.asarray(p), jnp.asarray(u), 0.6), TAYLOR)
    us = rng.uniform(-1, 1, size=(1, 10))
    out = port.synthesis_simulate(tp, torch.tensor(p), torch.tensor(us), 0.6)
    assert tuple(out.shape) == (16, 11)
    close(out, jsyn.synthesis_simulate(jp, jnp.asarray(p), jnp.asarray(us), 0.6), TAYLOR)


def test_plots_draw_what_jax_draws(tmp_path):
    """The same panels and the same drawn data as the JAX plots, from port
    tensors; each writes its PNG."""
    matplotlib.use("Agg")
    rng = np.random.default_rng(4)
    A = crandn(rng, 4, 12)
    t_fig, t_ax = tplot.plot_operator(torch.tensor(A), 4, path=str(tmp_path / "op.png"))
    j_fig, j_ax = jplot.plot_operator(A, 4)
    assert t_ax.shape == j_ax.shape == (2, 3) and (tmp_path / "op.png").stat().st_size > 0
    for ta, ja in zip(t_ax.flat, j_ax.flat):
        np.testing.assert_array_equal(ta.images[0].get_array(), ja.images[0].get_array())
    ts, us = np.arange(6) * 0.5, rng.uniform(-1, 1, (1, 6))
    xs = np.stack([density(rng, 2).flatten() for _ in range(7)], axis=1)
    targ = np.diag([0.0, 1.0]).astype(complex).flatten()
    t_fig, t_ax = tplot.plot_rollout(torch.tensor(ts), torch.tensor(us), torch.tensor(xs),
                                     torch.tensor(targ), sat=1.0, path=str(tmp_path / "r.png"))
    j_fig, j_ax = jplot.plot_rollout(ts, us, xs, targ, sat=1.0)
    assert len(t_ax) == len(j_ax) == 3 and (tmp_path / "r.png").stat().st_size > 0
    for ta, ja in zip(t_ax, j_ax):
        assert len(ta.lines) == len(ja.lines)
        for tl, jl in zip(ta.lines, ja.lines):
            np.testing.assert_array_equal(tl.get_xydata(), jl.get_xydata())
    import matplotlib.pyplot as plt

    plt.close("all")


def test_model_seam_left_open_is_the_dense_path():
    """model_fns=None runs the dense contractions: the flagship fleet (B =
    8, float64) and batched_mpc are torch.equal to the same runs with the
    dense linearization and prediction passed through the seam."""
    sc = tpresets.not_state(device="cpu")
    dense = ModelApplyFns(
        linearize=lambda A, X, U: tbil.model_along_traj(
            tbil.BilinearModel.from_stacked(A[..., :4], A[..., 4:], 1, sc.config.order), X, U),
        predict=lambda A, x, ux: t_predict(sc.model, x.T, ux.T).T,
        lift_u=None)
    plants = port.make_scenario_batch(sc.plant, 8)
    args = (sc.x0, sc.model, plants, sc.X_targ, sc.U_targ, sc.Q, sc.R, sc.Qf)
    runner = make_runner(sc, plants)
    runner_seam = make_runner(sc, plants)
    runner_seam.model_fns = dense
    out, out_seam = runner.run(*args), runner_seam.run(*args)
    assert torch.equal(out["final_x"], out_seam["final_x"])
    assert torch.equal(out["exit_code"], out_seam["exit_code"])
    cfg = dataclasses.replace(sc.config, n_steps=8, measure_freq=2)
    a = port.batched_mpc(*args, cfg, sc.sat, sc.du)
    b = port.batched_mpc(*args, cfg, sc.sat, sc.du, model_fns=dense)
    for f in ("xs", "us", "exit_code", "objs", "sqp_iters"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
