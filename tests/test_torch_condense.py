"""The model phase of small QPs in one kernel (kernels/condense.py,
csrc/condense_small.cu), on the CPU; imports no JAX.

The CUDA kernel runs only on the card (tests/test_torch_cuda.py). Here:
the wrapper's plain route is model_along_traj followed by qp_data; the
kernel's algebra, mirrored step by step in numpy (rows of A_t and B_t,
the column recurrence of M, G = Q^H M, P and q from G, the block-diagonal
R, the box), matches it in float64 at the flagship's, lindblad_state's and
not_gate's shapes and at two controls, orders 1-3; FleetRunner's rule
sends only a shared complex64 model on the card at dim_x, n <= 16 on the
small-QP or chol route to the kernel; the span qp.condense names the route
taken; and the benchmark's reader of that attribute gives None, 0 and 100.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import devtrace, spec  # noqa: E402
from mpc4quantum_tpu_torch import presets  # noqa: E402
from mpc4quantum_tpu_torch.benchfleet import make_runner  # noqa: E402
from mpc4quantum_tpu_torch.kernels import condense as condense_mod  # noqa: E402
from mpc4quantum_tpu_torch.kernels.condense import (CONDENSE_MODELS, condense_input,  # noqa: E402
                                                    condense_small, condense_small_ref,
                                                    condense_small_work)
from mpc4quantum_tpu_torch.models.dmdc import tile_lanes  # noqa: E402
from mpc4quantum_tpu_torch.mpc.driver import ModelApplyFns, bilinear_model  # noqa: E402
from mpc4quantum_tpu_torch.mpc.fleet_runner import FleetRunner  # noqa: E402
from mpc4quantum_tpu_torch.ops.bilinear import BilinearModel, model_along_traj  # noqa: E402
from mpc4quantum_tpu_torch.ops.library import size_of_library  # noqa: E402
from mpc4quantum_tpu_torch.parallel.fleet import make_scenario_batch  # noqa: E402
from mpc4quantum_tpu_torch.solvers.condense import qp_data  # noqa: E402
from mpc4quantum_tpu_torch.utils import profiling  # noqa: E402
from mpc4quantum_tpu_torch.utils.profiling import spans  # noqa: E402

OUTPUTS = ("P", "q", "lb", "ub", "w", "M")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module: under `-n 6` each test process's
    own pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def two_controls(order: int, rng) -> tuple:
    """A random model of 3 states and 2 controls at H 5 (n 10), its costs
    and targets: the shapes no preset of dim_u 1 reaches (Lm up to 9, R
    2 x 2 a step). Q is not Hermitian nor R symmetric, so an exchange of a
    transpose for the other shows."""
    dim_x, dim_u, H = 3, 2, 5
    Lm = size_of_library(order, dim_u) - 1
    cx = lambda *s: rng.normal(size=s) + 1j * rng.normal(size=s)
    A = cx(dim_x, dim_x)
    A = 0.9 * A / np.linalg.norm(A, 2)
    model = BilinearModel(A=torch.tensor(A), N=torch.tensor(0.3 * cx(dim_x, Lm, dim_x)),
                          dim_u=dim_u, order=order)
    G = cx(H + 1, dim_x, dim_x)
    Q_s = torch.tensor(G @ np.conj(np.swapaxes(G, 1, 2)) / dim_x + 0.2 * cx(H + 1, dim_x, dim_x))
    Rg = rng.normal(size=(H, dim_u, dim_u))
    R_s = torch.tensor(Rg @ np.swapaxes(Rg, 1, 2) + 0.1 * np.eye(dim_u)
                       + 0.2 * rng.normal(size=(H, dim_u, dim_u)))
    return model, H, Q_s, R_s, torch.tensor(cx(dim_x, H + 4)), torch.tensor(
        rng.normal(size=(dim_u, H + 3)) * 0.2)


def problem(shape: str, order: int, B: int, seed: int = 0) -> dict:
    """The arguments of condense_small in float64 on the CPU: the preset's
    own model, costs and targets (a window of them, as the runner takes
    it), random guesses, initial states and slew anchors."""
    rng = np.random.default_rng(seed + 10 * order + B)
    if shape == "two_controls":
        model, H, Q_s, R_s, X_targ, U_targ = two_controls(order, rng)
    else:
        sc = presets.PRESETS[shape](order=order, device="cpu", dtype=torch.float64)
        model = bilinear_model(sc.model, sc.config)
        H = sc.config.horizon
        Q_s = torch.cat([sc.Q.expand(H, -1, -1), sc.Qf[None]], dim=0).to(model.A.dtype)
        R_s = sc.R.expand(H, -1, -1)
        X_targ, U_targ = sc.X_targ, sc.U_targ
    dim_x, dim_u = model.dim_x, model.dim_u
    cx = lambda *s: torch.tensor(rng.normal(size=s) + 1j * rng.normal(size=s))
    Xg = 0.5 * cx(B, dim_x, H + 1)
    return dict(model=model, X=Xg[:, :, :H], U=torch.tensor(rng.uniform(-0.5, 0.5, (B, dim_u, H))),
                x_init=0.5 * cx(B, dim_x), X_bm=X_targ[:, 2:H + 3], U_bm=U_targ[:, 2:H + 2],
                Q_s=Q_s, R_s=R_s, u_prev=torch.tensor(rng.uniform(-0.3, 0.3, (B, dim_u))))


def kernel_mirror(model, X, U, x_init, X_bm, U_bm, Q_s, R_s, u_prev, sat, du):
    """csrc/condense_small.cu's arithmetic in numpy, lane by lane and step
    by step: the monomials by their exponents, the rows of A_t and B_t,
    w_{t+1} = A_t w_t - B_t u_t, M_{t+1} = A_t M_t with B_t in step t's
    columns, G = Q_{t+1}^H M_{t+1}, P[k, r] += Re(G[:, k]^H M[:, r]), q[r] +=
    Re(G[:, r]^H (w_{t+1} - xbm_{t+1})), then P[k, r] += R_t[k % du, r % du]
    on the diagonal blocks, q[r] -= R_t[r % du, :] U_bm[:, t], and the box."""
    A, N = model.A.numpy(), model.N.numpy()
    powers = model.lib_powers()
    X, U, x_init = X.numpy(), U.numpy(), x_init.numpy()
    X_bm, U_bm, Q, R = X_bm.numpy(), U_bm.numpy(), Q_s.numpy(), R_s.real.numpy()
    B, dim_x, H = X.shape
    dim_u = U.shape[1]
    n = H * dim_u
    out = dict(P=np.zeros((B, n, n)), q=np.zeros((B, n)), lb=np.zeros((B, n)),
               ub=np.zeros((B, n)), w=np.zeros((B, H + 1, dim_x), complex),
               M=np.zeros((B, H + 1, dim_x, n), complex))
    eye = np.eye(dim_u, dtype=np.int64)
    for b in range(B):
        u = U[b].T                                               # (H, dim_u)
        F = np.prod(u[:, None, :] ** powers[None], axis=-1)      # (H, Lm)
        DF = np.stack([np.where((powers[:, i] > 0)[None],
                                powers[None, :, i] * np.prod(
                                    u[:, None, :] ** np.maximum(powers - eye[i], 0)[None],
                                    axis=-1), 0.0)
                       for i in range(dim_u)], axis=1)           # (H, dim_u, Lm)
        w = x_init[b].copy()
        Mt = np.zeros((dim_x, n), complex)
        P, q = np.zeros((n, n)), np.zeros(n)
        out["w"][b, 0] = w
        for t in range(H):
            At = A + np.einsum("l,xly->xy", F[t], N)
            Bt = np.einsum("xly,y->xl", N, X[b, :, t]) @ DF[t].T
            w = At @ w - Bt @ u[t]
            Mt = At @ Mt
            Mt[:, t * dim_u:(t + 1) * dim_u] = Bt
            G = Q[t + 1].conj().T @ Mt
            P += (G.conj().T @ Mt).real
            q += (G.conj() * (w - X_bm[:, t + 1])[:, None]).sum(axis=0).real
            out["w"][b, t + 1], out["M"][b, t + 1] = w, Mt
        for r in range(n):
            t, i = divmod(r, dim_u)
            for k in range(t * dim_u, (t + 1) * dim_u):
                P[k, r] += R[t, k % dim_u, i]
            q[r] -= R[t, i] @ U_bm[:, t]
        lo = np.full(n, -np.inf if sat is None else -sat)
        hi = -lo
        if du is not None:
            lo[:dim_u] = np.maximum(lo[:dim_u], u_prev[b].numpy() - du)
            hi[:dim_u] = np.minimum(hi[:dim_u], u_prev[b].numpy() + du)
        out["P"][b], out["q"][b], out["lb"][b], out["ub"][b] = P, q, lo, hi
    out["M"] = out["M"].reshape(B, H + 1, dim_x, H, dim_u)
    return out


SHAPES = ("not_state", "lindblad_state", "not_gate", "two_controls")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("order", [1, 2, 3])
def test_plain_route_is_model_along_traj_then_qp_data(shape, order):
    p = problem(shape, order, 7)
    args = (p["x_init"], p["X_bm"], p["U_bm"], p["Q_s"], p["R_s"])
    ref = qp_data(*args, *model_along_traj(p["model"], p["X"], p["U"]), p["u_prev"], 0.6, 0.3)
    got = condense_small(**p, sat=0.6, du=0.3)
    for name, a, b in zip(OUTPUTS, got, ref):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("B", [1, 7])
@pytest.mark.parametrize("sat, du", [(0.6, 0.3), (None, 0.3), (0.6, None), (None, None)])
def test_kernel_algebra_matches_the_plain_route(shape, order, B, sat, du):
    p = problem(shape, order, B)
    got = dict(zip(OUTPUTS, condense_small_ref(**p, sat=sat, du=du)))
    mirror = kernel_mirror(**p, sat=sat, du=du)
    for name in OUTPUTS:
        ref = got[name].numpy()
        fin = np.isfinite(ref)
        np.testing.assert_array_equal(np.isinf(mirror[name]), ~fin, err_msg=name)
        np.testing.assert_array_equal(mirror[name][~fin], ref[~fin], err_msg=name)
        if fin.any():
            scale = max(1.0, float(np.abs(ref[fin]).max()))
            assert np.abs(mirror[name][fin] - ref[fin]).max() <= 1e-12 * scale, name


@pytest.mark.parametrize("shape", CONDENSE_MODELS,
                         ids=lambda shape: "x{}_h{}_u{}".format(*shape))
def test_kernel_algebra_at_every_instance(shape):
    """The random models of kernels/condense.CONDENSE_MODELS, on which the card
    holds the kernel's instances that no preset reaches: the mirror of its
    algebra matches the plain route there in float64 too."""
    p = condense_input(shape, 3, device="cpu", dtype=torch.float64)
    got = dict(zip(OUTPUTS, condense_small_ref(**p)))
    mirror = kernel_mirror(**p)
    for name in OUTPUTS:
        ref = got[name].numpy()
        assert np.isfinite(ref).all(), name
        scale = max(1.0, float(np.abs(ref).max()))
        assert np.abs(mirror[name] - ref).max() <= 1e-12 * scale, name


def rule_case(case: str):
    """(runner, bilinear model, dtype, device) of one case of the rule."""
    name = {"n_above_16": "cnot_state", "not_gate": "not_gate"}.get(case, "not_state")
    sc = presets.PRESETS[name](device="cpu")
    plants = make_scenario_batch(sc.plant, 2, generator=torch.Generator().manual_seed(1))
    kw = {"big_route": {"qp_kernel": "big"}}.get(case, {})
    runner = make_runner(sc, plants, **kw)
    cfg = runner.config
    if case == "chol":
        runner = FleetRunner(dataclasses.replace(cfg, qp_backend="chol"), sc.sat, sc.du)
    if case == "lqr":
        runner = FleetRunner(dataclasses.replace(cfg, solver="lqr"), sc.sat, sc.du)
    if case == "model_fns":
        fns = ModelApplyFns(model_along_traj, None, None)
        runner = FleetRunner(cfg, sc.sat, sc.du, model_fns=fns)
    model = tile_lanes(sc.model, 2) if case == "per_lane" else sc.model
    dtype = {"real_dtype": torch.float32, "complex128": torch.complex128}.get(
        case, torch.complex64)
    device = torch.device("cpu" if case == "cpu" else "cuda")
    return runner, bilinear_model(model, cfg), dtype, device


@pytest.mark.parametrize("case, route", [
    ("flagship", "kernel"), ("not_gate", "kernel"), ("chol", "kernel"),
    ("per_lane", "plain"), ("real_dtype", "plain"), ("complex128", "plain"), ("cpu", "plain"),
    ("n_above_16", "plain"), ("model_fns", "plain"), ("lqr", "plain"), ("big_route", "plain")])
def test_engagement_rule(case, route):
    runner, bmodel, dtype, device = rule_case(case)
    assert runner.condense_route(bmodel, dtype, device) == route


@pytest.mark.parametrize("dim_x, n, Lm, ok", [(4, 10, 2, True), (16, 16, 16, True),
                                              (17, 10, 2, False), (4, 17, 2, False),
                                              (4, 10, 17, False), (0, 10, 2, False)])
def test_kernel_limits(dim_x, n, Lm, ok):
    assert condense_mod.fits(dim_x, n, Lm) is ok


def traced_fleet(tmp_path: Path) -> tuple:
    """(outputs, the span records) of a traced 3-lane flagship fleet of 3
    steps on the CPU."""
    sc = presets.not_state(device="cpu")
    sc = dataclasses.replace(sc, config=dataclasses.replace(sc.config, n_steps=3))
    plants = make_scenario_batch(sc.plant, 3, generator=torch.Generator().manual_seed(2))
    runner = make_runner(sc, plants)
    with profile(activities=[ProfilerActivity.CPU]):
        out = runner.run(sc.x0, sc.model, plants, sc.X_targ, sc.U_targ, sc.Q, sc.R, sc.Qf,
                         record=True)
    return out, spans.runs[-1]


def test_span_names_the_route(tmp_path, monkeypatch):
    plain, run = traced_fleet(tmp_path)
    condense = [sp for sp in run if sp.name == "qp.condense"]
    iters = sum(sp.name == "sqp.iter" for sp in run)
    assert len(condense) == iters > 0
    assert {sp.attrs["route"] for sp in condense} == {"plain"}
    # the kernel route, its plain version on the CPU: the same numbers; the
    # linearization runs inside qp.condense, sqp.linearize stays empty
    monkeypatch.setattr(FleetRunner, "condense_route", lambda self, *a: "kernel")
    launches = condense_small.launches
    out, run = traced_fleet(tmp_path)
    assert condense_small.launches == launches
    condense = [sp for sp in run if sp.name == "qp.condense"]
    linearize = [sp for sp in run if sp.name == "sqp.linearize"]
    assert len(condense) == len(linearize) == iters
    assert {sp.attrs["route"] for sp in condense} == {"kernel"}
    assert {sp.parent.name for sp in condense} == {"sqp.iter"}
    assert not any(sp.parent in linearize for sp in run)
    for k in ("final_x", "exit_code", "xs", "us", "objs", "sqp_iters"):
        assert torch.equal(out[k], plain[k]), k


def planted(routes):
    """A window of one run whose qp.condense spans carry the attribute route
    of each entry of `routes` (None: no attribute)."""
    run = [profiling.Span(spans, "fleet.run", False, None)]
    run[0].start_ns, run[0].end_ns = 1, 10 ** 9
    for k, route in enumerate(routes):
        sp = profiling.Span(spans, "qp.condense", False,
                            None if route is None else {"route": route})
        sp.start_ns, sp.end_ns = 2 + k, 3 + k
        run.append(sp)
    return run


@pytest.mark.parametrize("routes, pct", [(["kernel"] * 26, 100.0), (["plain"] * 26, 0.0),
                                         (["plain"] * 2 + ["kernel"] * 6, 75.0),
                                         ([None] * 26, None), ([], None)])
def test_condense_kernel_reader(monkeypatch, routes, pct):
    monkeypatch.setattr(spans, "runs", [planted(routes)])
    read = spec.metric_reader("condense_kernel_pct.fleet")
    s = devtrace.Summary(entry="fleet", steps=20, rollouts=1, window_s=1.0, busy_s=0.0,
                         runtime_calls=0, syncs=0, fn_device_s={}, fn_launches={},
                         schedule={}, device_ops=[], idle_gaps=[])
    assert read(s) == pct
    assert read(dataclasses.replace(s, entry="rollout")) is None


def test_work_at_the_flagship():
    """~4.8 KB a lane, M 3.5 KB of it; ~25 kFLOP a lane."""
    flops, nbytes = condense_small_work(1, 4, 10, 1, 2)
    lane = condense_small_work(2, 4, 10, 1, 2)[1] - nbytes
    assert lane == 320 + 40 + 32 + 4 + 400 + 120 + 352 + 3520
    assert flops == 25440
    assert condense_small_work(131072, 4, 10, 1, 2)[1] == pytest.approx(0.63e9, rel=0.01)


def test_wrapper_refuses_other_devices():
    p = problem("not_state", 2, 1)
    p["X"] = p["X"].to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        condense_small(**p)
