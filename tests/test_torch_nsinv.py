"""The cold Newton-Schulz K^-1 in one kernel (kernels/nsinv.py,
csrc/ns_cold.cu); imports no JAX.

On the CPU: the wrapper is the plain chain (solvers/boxqp._ns_inverse);
`fits` takes float32 on the card at MIN_N <= n <= MAX_N only;
boxqp_big hands the kernel to solve_boxqp_fixed, which takes it for a cold
"ns" chain where it fits and nowhere else (a stub in its place records the
calls); a float32 mirror of the kernel's arithmetic (X + X (I - K X), the
last step's residual in float64) holds the plain chain's residual, where
one triangle of either product, mirrored, does not; the benchmark's reader
of qp.kinv's route gives None, 0 and 100.

On the card (marked cuda): the kernel against the plain chain on random SPD
K at conditions 1e2-1e5 and on cnot_state's first QPs, a captured replay
equal to the eager call, the refusals, and boxqp_big through it.
"""

import dataclasses
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import devtrace, spec  # noqa: E402
from mpc4quantum_tpu_torch import presets  # noqa: E402
from mpc4quantum_tpu_torch.benchfleet import run_hostloop_fleet  # noqa: E402
from mpc4quantum_tpu_torch.kernels import _build  # noqa: E402
from mpc4quantum_tpu_torch.kernels import boxqp as boxqp_mod  # noqa: E402
from mpc4quantum_tpu_torch.kernels import nsinv  # noqa: E402
from mpc4quantum_tpu_torch.kernels.nsinv import MAX_N, MIN_N, ns_cold  # noqa: E402
from mpc4quantum_tpu_torch.mpc.fleet_runner import FleetRunner  # noqa: E402
from mpc4quantum_tpu_torch.solvers import boxqp as solver  # noqa: E402
from mpc4quantum_tpu_torch.solvers.boxqp import BoxQPParams, _ns_inverse  # noqa: E402
from mpc4quantum_tpu_torch.utils import profiling  # noqa: E402
from mpc4quantum_tpu_torch.utils.profiling import spans  # noqa: E402

# max |X - X_plain| relative to max |X_plain|: a chain that has not
# converged at its budget (condition 1e5 at 16-30 steps) carries the
# rounding of another order of sums, amplified (1.3e-3 in the float32
# mirror below); converged chains agree to ~1e-6
REL_TOL = 5e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module: under `-n 6` each test process's
    own pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def spd(B: int, n: int, seed: int, device="cpu") -> torch.Tensor:
    """B symmetric positive definite float32 (n, n), lane b of condition
    10^(2 + 3 b / (B - 1)) (1e3 for one lane), formed in float64."""
    g = torch.Generator().manual_seed(seed)
    Q = torch.linalg.qr(torch.randn(B, n, n, generator=g, dtype=torch.float64))[0]
    cond = torch.logspace(2, 5, B, dtype=torch.float64) if B > 1 else torch.tensor([1e3])
    ev = cond[:, None] ** torch.linspace(0, 1, n, dtype=torch.float64)[None]
    K = (Q * ev[:, None, :]) @ Q.mT
    return (0.5 * (K + K.mT)).to(device, torch.float32)


def residual(K, X) -> torch.Tensor:
    """(B,) ||I - K X||_inf in float64."""
    eye = torch.eye(K.shape[-1], dtype=torch.float64, device=K.device)
    return (eye - K.double() @ X.double()).abs().sum(dim=-1).amax(dim=-1)


def assert_tracks_plain(K, X, iters):
    """Per lane ||I - K X||_inf <= 2 ||I - K X_plain||_inf + 1e-6 and X
    within REL_TOL of the plain chain."""
    Xp = _ns_inverse(K, iters)[0]
    assert bool((residual(K, X) <= 2 * residual(K, Xp) + 1e-6).all())
    rel = (X - Xp).abs().amax(dim=(-1, -2)) / Xp.abs().amax(dim=(-1, -2))
    assert float(rel.max()) <= REL_TOL


@pytest.fixture(scope="module")
def cnot_K():
    """(21, 150, 150) float32: the K = P + (sigma + rho) I of cnot_state's
    cold chains in its first step (7 SQP iterations x 3 rho rounds), lane 0,
    from a float64 CPU fleet of 2 lanes."""
    sc = presets.cnot_state(order=2, device="cpu")
    sc = dataclasses.replace(sc, config=dataclasses.replace(sc.config, n_steps=1))
    Ks, plain = [], solver.ns_inverse

    def record(K, iters=30, X0=None, guard=0.5):
        if X0 is None:
            Ks.append(K[0].clone())
        return plain(K, iters, X0, guard)
    solver.ns_inverse = record
    try:
        run_hostloop_fleet(sc, 2)
    finally:
        solver.ns_inverse = plain
    return torch.stack(Ks).float()


# --- on the CPU ---------------------------------------------------------------


@pytest.mark.parametrize("n", [MIN_N, 50, MAX_N])
@pytest.mark.parametrize("iters", [0, 1, 20])
def test_wrapper_on_the_cpu_is_the_plain_chain(n, iters):
    K = spd(3, n, n)
    assert torch.equal(ns_cold(K, iters), _ns_inverse(K, iters)[0])
    K64 = K.double()
    assert torch.equal(ns_cold(K64, iters), _ns_inverse(K64, iters)[0])


def on(device: str, shape, dtype=torch.float32):
    """A stand-in for a tensor on `device` (no card here): what `fits` reads."""
    return SimpleNamespace(device=torch.device(device), dtype=dtype, shape=torch.Size(shape),
                           dim=lambda: len(shape))


@pytest.mark.parametrize("K, ok", [
    (on("cuda", (4, MIN_N, MIN_N)), True), (on("cuda", (1024, 150, 150)), True),
    (on("cuda", (2, MAX_N, MAX_N)), True), (on("cuda", (4, MIN_N - 1, MIN_N - 1)), False),
    (on("cuda", (4, MAX_N + 1, MAX_N + 1)), False),
    (on("cuda", (4, 150, 150), torch.float64), False), (on("cuda", (150, 150)), False),
    (on("cuda", (4, 150, 149)), False), (on("cpu", (4, 150, 150)), False),
    (on("meta", (4, 150, 150)), False)])
def test_fits(K, ok):
    assert nsinv.fits(K) is ok


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        ns_cold(torch.empty(2, 50, 50, device="meta"), 20)


def stub_kernel(calls: list):
    """ns_cold with its device rule lifted (the card's test of it is
    `fits`): records each call's (n, dtype, iters), returns the plain chain."""
    def stub(K, iters):
        calls.append((K.shape[-1], K.dtype, iters))
        return _ns_inverse(K, iters)[0]
    stub.fits = lambda K: nsinv.fits(on("cuda", tuple(K.shape), K.dtype))
    return stub


def qp(n: int, dtype=torch.float32, B: int = 3):
    g = torch.Generator().manual_seed(n)
    G = torch.randn(B, n, n, generator=g, dtype=torch.float64)
    P = G @ G.mT / n + 0.5 * torch.eye(n, dtype=torch.float64)
    q = torch.randn(B, n, generator=g, dtype=torch.float64)
    return [t.to(dtype) for t in (P, q, -torch.ones(B, n), torch.ones(B, n))]


@pytest.mark.parametrize("case, n, kernel", [
    ("cold", MIN_N, True), ("cold", 50, True), ("cold", MAX_N, True),
    ("cold", MAX_N + 1, False), ("float64", 50, False), ("kinv0", 50, False),
    ("gj", 50, False)])
def test_boxqp_big_route(monkeypatch, case, n, kernel):
    calls = []
    monkeypatch.setattr(boxqp_mod, "ns_cold", stub_kernel(calls))
    P, q, lb, ub = qp(n, torch.float64 if case == "float64" else torch.float32)
    kw = dict(iters=20, rounds=3, ns_iters=12, ns_refresh=5,
              kinv_method="gj" if case == "gj" else "ns")
    if case == "kinv0":
        kw["kinv0"] = _ns_inverse(P + torch.eye(n), 20)[0]
    out = boxqp_mod.boxqp_big(P, q, lb, ub, **kw)
    assert calls == ([(n, torch.float32, 12)] * 3 if kernel else [])
    monkeypatch.setattr(boxqp_mod, "ns_cold", None)
    plain = boxqp_mod.boxqp_big(P, q, lb, ub, **kw)
    for a, b in zip(out[:2], plain[:2]):
        assert torch.equal(a, b)


def kernel_form(K, iters: int, mirror: str = ""):
    """csrc/ns_cold.cu's arithmetic in float32 PyTorch, its order of sums
    aside: X + X E, E = I - K X, the last step's E in float64. With mirror
    "kx" or "xe", the upper triangle of K X or of X + X E, mirrored: the
    triangle forms the kernel does not take."""
    sym = lambda M: torch.triu(M) + torch.triu(M, 1).mT
    eye = torch.eye(K.shape[-1], dtype=K.dtype)
    n1 = K.abs().sum(dim=-2).amax(dim=-1)
    ninf = K.abs().sum(dim=-1).amax(dim=-1)
    X = K.mT / (n1 * ninf)[..., None, None]
    for i in range(iters):
        if i + 1 < iters:
            T = K @ X
            E = eye - (sym(T) if mirror == "kx" else T)
        else:
            E = (eye.double() - K.double() @ X.double()).to(K.dtype)
        X = X + X @ E
        X = sym(X) if mirror else X
    return X


@pytest.mark.parametrize("iters", [16, 20, 30])
def test_kernel_form_tracks_the_plain_chain(cnot_K, iters):
    for K in (cnot_K, spd(16, 150, 1), spd(16, 32, 2), spd(64, 50, 3)):
        assert_tracks_plain(K, kernel_form(K, iters), iters)


@pytest.mark.parametrize("mirror, iters", [("kx", 20), ("xe", 40)])
def test_one_triangle_does_not_hold_the_residual(cnot_K, mirror, iters):
    """Why the kernel forms both products in full: every iterate is a
    polynomial in K, so both are symmetric in exact arithmetic, but with one
    triangle mirrored the rounding that does not commute with K is not
    damped, and it grows once the chain has converged: on cnot's first QPs
    with K X mirrored, on SPD K at condition 4e3-8e4 with X + X E mirrored."""
    K = cnot_K if mirror == "kx" else spd(64, 50, 3)[36:56]
    plain = residual(K, _ns_inverse(K, iters)[0])
    mirrored = residual(K, kernel_form(K, iters, mirror))
    assert not bool((mirrored <= 10 * plain).all())
    assert bool((residual(K, kernel_form(K, iters)) <= 2 * plain + 1e-6).all())


def planted(routes):
    """A window of one run whose qp.kinv spans carry the attribute route of
    each entry of `routes` (None: no attribute)."""
    run = [profiling.Span(spans, "fleet.run", False, None)]
    run[0].start_ns, run[0].end_ns = 1, 10 ** 9
    for k, route in enumerate(routes):
        sp = profiling.Span(spans, "qp.kinv", False, None if route is None else {"route": route})
        sp.start_ns, sp.end_ns = 2 + k, 3 + k
        run.append(sp)
    return run


@pytest.mark.parametrize("routes, pct", [(["kernel"] * 222, 100.0), (["plain"] * 222, 0.0),
                                         (["plain"] * 2 + ["kernel"] * 6, 75.0),
                                         ([None] * 222, None), ([], None)])
def test_kinv_kernel_reader(monkeypatch, routes, pct):
    monkeypatch.setattr(spans, "runs", [planted(routes)])
    read = spec.metric_reader("kinv_kernel_pct.fleet")
    s = devtrace.Summary(entry="fleet", steps=200, rollouts=1, window_s=1.0, busy_s=0.0,
                         runtime_calls=0, syncs=0, fn_device_s={}, fn_launches={},
                         schedule={}, device_ops=[], idle_gaps=[])
    assert read(s) == pct
    assert read(dataclasses.replace(s, entry="rollout")) is None


# --- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [MIN_N, 32, 50, 150, MAX_N])
@pytest.mark.parametrize("B", [1, 128, 1024])
@pytest.mark.parametrize("iters", [16, 20, 30])
def test_kernel_matches_plain(cuda, n, B, iters):
    K = spd(B, n, n, cuda)
    launches = ns_cold.launches
    X = ns_cold(K, iters)
    assert ns_cold.launches == launches + 1
    assert_tracks_plain(K, X, iters)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 128, 1024])
@pytest.mark.parametrize("iters", [16, 20, 30])
def test_kernel_on_cnot_first_qps(cuda, cnot_K, B, iters):
    K = cnot_K.to(cuda).repeat((B + len(cnot_K) - 1) // len(cnot_K), 1, 1)[:B].contiguous()
    assert_tracks_plain(K, ns_cold(K, iters), iters)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [MIN_N, 150])
def test_captured_replay_equals_the_call(cuda, n):
    K = spd(128, n, 5, cuda)
    eager = ns_cold(K, 20)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ns_cold(K, 20)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ns_cold(K, 20)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    for K in (spd(2, MIN_N - 1, 1, cuda), spd(2, MAX_N + 1, 1, cuda),
              spd(2, 50, 1, cuda).double(), spd(2, 50, 1, cuda)[:, :, :49]):
        with pytest.raises(ValueError):
            ns_cold(K, 20)
    with pytest.raises(ValueError):
        ns_cold(spd(2, 50, 1, cuda), -1)
    K, X = spd(2, MIN_N - 1, 1, cuda), torch.empty(2, MIN_N - 1, MIN_N - 1, device=cuda)
    rc = _build.library().mpc4q_ns_cold(K.data_ptr(), X.data_ptr(), 2, MIN_N - 1, 20,
                                        torch.cuda.current_stream().cuda_stream)
    with pytest.raises(RuntimeError):
        _build.check(rc, "ns_cold")


@pytest.mark.cuda
def test_boxqp_big_takes_the_kernel_on_the_card(cuda):
    P, q, lb, ub = (t.to(cuda) for t in qp(150, B=64))
    params = BoxQPParams(rho0=1.0, max_iter=100, n_rounds=3, ns_iters=20, eps_abs=1e-8,
                         eps_rel=1e-8)
    launches = ns_cold.launches
    z, y, aux = boxqp_mod.boxqp_big(P, q, lb, ub, iters=100, rounds=3, rho_scale=1.0,
                                    ns_iters=20, eps_abs=1e-8, eps_rel=1e-8)[:3]
    assert ns_cold.launches == launches + 3
    zp, yp, auxp = solver.solve_boxqp_fixed(P, q, lb, ub, params=params)[:3]
    scale = lambda t: max(1.0, float(t.abs().max()))
    assert float((z - zp).abs().max()) <= 1e-3 * scale(zp)
    assert float((y - yp).abs().max()) <= 1e-3 * scale(yp)


@pytest.mark.cuda
def test_cnot_fleet_on_the_card_takes_the_kernel(cuda):
    """cnot_state's runner on the card: every K^-1 of a 4-step fleet is one
    ns_cold launch, captured and replayed."""
    sc = presets.cnot_state(order=2)
    sc = dataclasses.replace(sc, config=dataclasses.replace(sc.config, n_steps=4))
    assert FleetRunner._graphs
    launches = ns_cold.launches
    metrics, _ = run_hostloop_fleet(sc, 16)
    assert ns_cold.launches - launches == 7 * 3 + 1 * 3 + 2 * 1
    assert metrics["completed_frac"] == 1.0 and metrics["qp_fail_frac"] == 0.0
