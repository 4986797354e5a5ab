"""CUDA-graph capture of the fleet step (mpc/step_graphs.py); imports no JAX.

On the CPU: the signature moves with each input that selects the code of a
step and with nothing else; the CPU, model_fns, streaming and chol runs stay
eager and capture nothing; and the pieces' data flow (static buffers, copies
in, outputs left in the buffers, pieces replayed in any order) gives what an
eager run gives, with the capture emulated by calling the piece again on its
buffers.

On the card (marked cuda, skipped elsewhere): captured fleets and rollouts
equal to eager ones, a second `mpc()` call that captures nothing, and the
kernels' launch counters equal to eager's. Run them there with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_graphs.py
"""

import dataclasses

import pytest
import torch

from mpc4quantum_tpu_torch import mpc, presets
from mpc4quantum_tpu_torch.benchfleet import make_runner, rescue_pass
from mpc4quantum_tpu_torch.kernels.admm_big import admm_big
from mpc4quantum_tpu_torch.kernels.boxqp import boxqp_small
from mpc4quantum_tpu_torch.kernels.expm import expm_small
from mpc4quantum_tpu_torch.mpc import step_graphs
from mpc4quantum_tpu_torch.mpc.driver import ModelApplyFns
from mpc4quantum_tpu_torch.mpc.fleet_runner import FleetRunner
from mpc4quantum_tpu_torch.mpc.step_graphs import StepGraphs
from mpc4quantum_tpu_torch.parallel.fleet import make_scenario_batch
from mpc4quantum_tpu_torch.presets import DistanceExit
from mpc4quantum_tpu_torch.solvers.boxqp import BoxQPParams

RECORD = ("final_x", "exit_code", "xs", "us", "objs", "sqp_iters", "n_valid")
MPC_FIELDS = ("xs", "us", "exit_code", "n_valid", "objs", "sqp_iters")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module: under `-n 6` each test process's
    own pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fleet(name="not_state", B=4, device="cpu", seed=1, n_steps=None, **runner_kw):
    """(scenario, plants, runner) of a preset fleet."""
    sc = presets.PRESETS[name](device=device)
    if n_steps is not None:
        sc = dataclasses.replace(sc, config=dataclasses.replace(sc.config, n_steps=n_steps))
    plants = make_scenario_batch(sc.plant, B, generator=torch.Generator().manual_seed(seed))
    return sc, plants, make_runner(sc, plants, **runner_kw)


def run(sc, plants, runner):
    return runner.run(sc.x0, sc.model, plants, sc.X_targ, sc.U_targ, sc.Q, sc.R, sc.Qf,
                      record=True)


def run_inputs(sc, plants, runner, x0=None):
    """The arguments of step_graphs.signature as FleetRunner.run forms them."""
    H = sc.config.horizon
    x0 = (sc.x0 if x0 is None else x0).to(plants.device, plants.dtype)
    Q_s = torch.cat([sc.Q.expand(H, -1, -1), sc.Qf[None]], dim=0).to(sc.model.A.dtype)
    return dict(runner=runner, plants=plants, model=sc.model, Q_s=Q_s,
                R_s=sc.R.expand(H, -1, -1), X_targ=sc.X_targ, U_targ=sc.U_targ,
                x0=x0.expand(plants.lanes, -1), noise=None, observe_fn=None, record=True)


def sig(**kw):
    return step_graphs.signature(**kw)


def test_signature_ignores_values():
    sc, plants, runner = fleet(seed=1)
    base = sig(**run_inputs(sc, plants, runner))
    _, plants2, runner2 = fleet(seed=2)
    assert not torch.equal(plants.H0, plants2.H0)
    assert sig(**run_inputs(sc, plants2, runner2)) == base
    # other targets, another start, another run length, other warm iterations
    longer = dataclasses.replace(sc.config, n_steps=40, max_iter=7)
    sc2 = dataclasses.replace(sc, X_targ=sc.X_targ * 0.5, U_targ=sc.U_targ + 1.0,
                              x0=sc.x0.flip(0), config=longer)
    runner3 = make_runner(sc2, plants, warm_sqp_iters=(3, 2))
    assert sig(**run_inputs(sc2, plants, runner3)) == base


def _changed(sc, plants, runner):
    """Runs whose inputs each differ from (sc, plants, runner) in one thing
    that selects the code of a step: {what: signature arguments}."""
    kw = run_inputs(sc, plants, runner)
    cfg = sc.config
    out = {}
    out["lanes"] = run_inputs(sc, plants[:2], make_runner(sc, plants[:2]))
    sc32 = presets.not_state(device="cpu", dtype=torch.float32)
    p32 = make_scenario_batch(sc32.plant, plants.lanes, generator=torch.Generator().manual_seed(1))
    out["dtype"] = run_inputs(sc32, p32, make_runner(sc32, p32))
    scH = dataclasses.replace(sc, config=dataclasses.replace(cfg, horizon=8))
    out["horizon"] = run_inputs(scH, plants, make_runner(scH, plants))
    out["order"] = run_inputs(*(lambda s: (s, plants, make_runner(s, plants)))(
        presets.not_state(order=3, device="cpu")))
    out["route"] = run_inputs(sc, plants, make_runner(sc, plants, qp_kernel="big"))
    warm = make_runner(sc, plants)
    warm.config = dataclasses.replace(cfg, qp_params=dataclasses.replace(cfg.qp_params,
                                                                         max_iter=13))
    out["warm budget"] = {**kw, "runner": warm}
    steady = make_runner(sc, plants, steady_qp_params=BoxQPParams(max_iter=11))
    out["steady budget"] = {**kw, "runner": steady}
    out["dual seed"] = {**kw, "runner": make_runner(sc, plants, warm_duals=False)}
    big = make_runner(sc, plants, qp_kernel="big")
    out["kinv carry"] = ({**kw, "runner": make_runner(sc, plants, qp_kernel="big",
                                                      warm_kinv=True)}, big)
    early = make_runner(sc, plants)
    early.early_exit = True
    out["early exit"] = {**kw, "runner": early}
    exit_ = make_runner(sc, plants)
    exit_.exit_condition = DistanceExit(sc.target_state, 1e-2)
    out["exit condition"] = {**kw, "runner": exit_}
    expm = make_runner(sc, plants, expm_budget="any_norm")
    out["expm budget"] = {**kw, "runner": expm}
    sat = make_runner(sc, plants)
    sat.sat = 0.5 * sat.sat
    out["box"] = {**kw, "runner": sat}
    tol = make_runner(sc, plants)
    tol.config = dataclasses.replace(cfg, step_tol=1e-5)
    out["step tolerance"] = {**kw, "runner": tol}
    out["noise"] = {**kw, "noise": torch.zeros((cfg.n_steps, plants.lanes, 4),
                                               dtype=plants.dtype)}
    out["observation"] = {**kw, "observe_fn": lambda p, x, n: x}
    out["record"] = {**kw, "record": False}
    return out


CHANGES = ("lanes", "dtype", "horizon", "order", "route", "warm budget", "steady budget",
           "dual seed", "kinv carry", "early exit", "exit condition", "expm budget", "box",
           "step tolerance", "noise", "observation", "record")


@pytest.mark.parametrize("what", CHANGES)
def test_signature_moves_with_what_selects_the_code(what):
    sc, plants, runner = fleet()
    changed = _changed(sc, plants, runner)[what]
    base = sig(**run_inputs(sc, plants, runner))
    if isinstance(changed, tuple):
        # the K-inverse carry exists on the big route only: against that route
        changed, runner = changed
        base = sig(**run_inputs(sc, plants, runner))
    assert sig(**changed) != base


def test_piece_keys():
    sc, plants, runner = fleet(qp_kernel="big", warm_kinv=True)
    keys = lambda step, kinv=None: step_graphs.piece_keys(runner, step, kinv)
    # steps 0 and 1: warm iterations anchored at the benchmark control
    assert keys(0) == keys(1) == (("begin",), ("iter", False, False, False), ("end", True))
    assert keys(2) == (("begin",), ("iter", True, True, False), ("end", True))
    assert keys(3, torch.zeros(1))[1] == ("iter", True, True, True)
    # a warm step takes no K-inverse
    assert keys(1, torch.zeros(1))[1] == ("iter", False, False, False)
    # between measurements the loop closes through the model
    runner.config = dataclasses.replace(runner.config, measure_freq=5)
    assert [keys(s)[2][1] for s in range(6)] == [False] * 4 + [True, False]
    # without the warm start every step is warm, anchored at the last control after step 1
    runner.config = dataclasses.replace(runner.config, warm_start=False)
    assert keys(7)[1] == ("iter", False, True, False)


@pytest.mark.parametrize("case", ["cpu", "model_fns", "streaming", "chol"])
def test_eager_inputs(case):
    sc, plants, runner = fleet()
    assert step_graphs.eager_reason(runner, "cuda", False) is None
    if case == "cpu":
        assert step_graphs.eager_reason(runner, "cpu", False) == "not on the card"
        before = (StepGraphs.captures, StepGraphs.replays, StepGraphs.eager,
                  list(step_graphs._CACHE))
        out = run(sc, plants, runner)
        assert out["exit_code"].eq(0).all()
        assert (StepGraphs.captures, StepGraphs.replays, StepGraphs.eager,
                list(step_graphs._CACHE)) == before
        return
    if case == "model_fns":
        runner = FleetRunner(sc.config, sc.sat, sc.du,
                             model_fns=ModelApplyFns(linearize=None, predict=None, lift_u=None))
        assert step_graphs.eager_reason(runner, "cuda", False) == "model_fns"
    elif case == "streaming":
        assert step_graphs.eager_reason(runner, "cuda", True) == "streaming refit"
    else:
        runner = FleetRunner(dataclasses.replace(sc.config, qp_backend="chol"), sc.sat, sc.du)
        assert runner.qp_kernel == "chol"
        assert step_graphs.eager_reason(runner, "cuda", False) == "chol QP"
    # the forced eager path of the card tests
    runner._graphs = False
    assert step_graphs.eager_reason(runner, "cuda", False) is not None


@pytest.fixture
def emulated(monkeypatch):
    """The graph path on the CPU with the capture emulated: a piece's
    "graph" calls the piece again on its static buffers and copies its
    outputs into them, as a replay of its capture would."""
    reason = step_graphs.eager_reason
    monkeypatch.setattr(step_graphs, "eager_reason",
                        lambda runner, device, streaming: reason(runner, "cuda", streaming))
    monkeypatch.setattr(StepGraphs, "_record",
                        lambda self, fn, sv: [("call", fn, sv, self)])
    replay = step_graphs._replay

    def emulated_replay(ops):
        for op in ops:
            if op[0] == "call":
                op[3]._write(op[1](op[2]))
            else:
                replay([op])
    monkeypatch.setattr(step_graphs, "_replay", emulated_replay)
    monkeypatch.setattr(step_graphs, "_CACHE", type(step_graphs._CACHE)())


EMULATED = {"flagship": ("not_state", 4, {}),
            "big_route": ("not_state", 2, {"qp_kernel": "big"}),
            "kinv_carry": ("drag_state", 2, {"warm_kinv": True}),
            "exit": ("not_gate", 2, {})}


@pytest.mark.parametrize("case", list(EMULATED))
def test_emulated_pieces_equal_eager(emulated, case):
    name, B, kw = EMULATED[case]
    sc, plants, runner = fleet(name, B, **kw)
    runner._graphs = False
    eager = run(sc, plants, runner)
    counts = runner.kinv_counts
    runner._graphs = True
    eager_pieces = StepGraphs.eager
    for _ in range(2):
        out = run(sc, plants, runner)
        for k in RECORD:
            assert torch.equal(out[k], eager[k]), k
        if counts is not None:
            assert torch.equal(runner.kinv_counts, counts)
    # each piece ran eagerly once, on its first use
    (graphs,) = step_graphs._CACHE.values()
    assert StepGraphs.eager - eager_pieces == len(graphs.scripts)
    # the outputs are the run's own, not the buffers the next run writes
    assert out["final_x"].data_ptr() != graphs.static["c.x_cur"].data_ptr()


def test_emulated_rollouts_equal_eager(emulated, monkeypatch):
    sc = presets.not_state(device="cpu")
    args = {**sc.mpc_args(), "config": dataclasses.replace(sc.config, qp_backend="ns")}
    monkeypatch.setattr(FleetRunner, "_graphs", False)
    eager = mpc(**args)
    monkeypatch.setattr(FleetRunner, "_graphs", True)
    first = mpc(**args)
    pieces = StepGraphs.eager
    plant2 = make_scenario_batch(sc.plant, 1, generator=torch.Generator().manual_seed(5))[0]
    second = mpc(**{**args, "plant": plant2})
    assert StepGraphs.eager == pieces and len(step_graphs._CACHE) == 1
    monkeypatch.setattr(FleetRunner, "_graphs", False)
    eager2 = mpc(**{**args, "plant": plant2})
    for f in MPC_FIELDS:
        assert torch.equal(getattr(first, f), getattr(eager, f)), f
        assert torch.equal(getattr(second, f), getattr(eager2, f)), f


# -- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CARD = {"flagship_b64": ("not_state", 64, None, {}),
        "cnot_b16": ("cnot_state", 16, 6, {}),
        "kinv_carry": ("not_state_freq", 16, 12, {"warm_kinv": True}),
        "big_route": ("not_state", 64, None, {"qp_kernel": "big"}),
        "exit": ("not_gate", 32, None, {})}


def _launches():
    return (boxqp_small.launches, admm_big.launches, expm_small.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD))
def test_captured_fleet_equals_eager(cuda, case):
    name, B, n_steps, kw = CARD[case]
    sc, plants, runner = fleet(name, B, device=cuda, n_steps=n_steps, **kw)
    runner._graphs = False
    run(sc, plants, runner)  # the kernels' first launches, outside the comparison
    before = _launches()
    eager = run(sc, plants, runner)
    per_run = tuple(a - b for a, b in zip(_launches(), before))
    counts = runner.kinv_counts
    runner._graphs = True
    captures = StepGraphs.captures
    for k in range(3):
        before = _launches()
        out = run(sc, plants, runner)
        # the first run captures; the launch counters count what ran
        assert tuple(a - b for a, b in zip(_launches(), before)) == per_run
        if k:
            assert StepGraphs.captures == captures
        captures = StepGraphs.captures
        for f in RECORD:
            assert torch.equal(out[f], eager[f]), (f, k)
        if counts is not None:
            assert torch.equal(runner.kinv_counts, counts)


@pytest.mark.cuda
def test_second_mpc_call_captures_nothing(cuda, monkeypatch):
    sc = presets.not_state(device=cuda)
    args = {**sc.mpc_args(), "config": dataclasses.replace(sc.config, qp_backend="ns")}
    pool = make_scenario_batch(sc.plant, 3, generator=torch.Generator().manual_seed(7))
    monkeypatch.setattr(FleetRunner, "_graphs", False)
    mpc(**args)
    eager = []
    for k in range(3):
        before = _launches()
        eager.append((mpc(**{**args, "plant": pool[k]}),
                      tuple(a - b for a, b in zip(_launches(), before))))
    monkeypatch.setattr(FleetRunner, "_graphs", True)
    mpc(**{**args, "plant": pool[2]})
    captures, replays = StepGraphs.captures, StepGraphs.replays
    for k in range(3):
        before = _launches()
        res = mpc(**{**args, "plant": pool[k]})
        assert tuple(a - b for a, b in zip(_launches(), before)) == eager[k][1]
        for f in MPC_FIELDS:
            assert torch.equal(getattr(res, f), getattr(eager[k][0], f)), (f, k)
    assert StepGraphs.captures == captures and StepGraphs.replays > replays


@pytest.mark.cuda
def test_lqr_rollout_captured(cuda, monkeypatch):
    sc = presets.not_state(device=cuda)
    args = {**sc.mpc_args(), "config": dataclasses.replace(sc.config, solver="lqr")}
    monkeypatch.setattr(FleetRunner, "_graphs", False)
    eager = mpc(**args)
    monkeypatch.setattr(FleetRunner, "_graphs", True)
    mpc(**args)
    captures = StepGraphs.captures
    res = mpc(**args)
    assert StepGraphs.captures == captures
    for f in MPC_FIELDS:
        assert torch.equal(getattr(res, f), getattr(eager, f)), f


@pytest.mark.cuda
def test_rescue_pass_on_captured_fleet(cuda):
    """A cnot fleet whose lanes all go to the order-3 rescue (cut to 20
    steps), captured and eager: the same lanes, states and codes."""
    sc, plants, runner = fleet("cnot_state", 8, device=cuda, n_steps=20)
    rescue = {"threshold": 0.99,
              "scenario": dataclasses.replace(
                  presets.cnot_state(order=3, device=cuda),
                  config=dataclasses.replace(presets.cnot_state(order=3, device=cuda).config,
                                             n_steps=20))}
    from mpc4quantum_tpu_torch.benchfleet import fleet_fidelity
    outs = []
    for graphs in (False, True, True):
        FleetRunner._graphs = graphs
        try:
            out = run(sc, plants, runner)
            info = rescue_pass(sc, rescue, plants, out, fleet_fidelity(sc, out["final_x"]), "auto")
        finally:
            FleetRunner._graphs = True
        assert info["rescued_lanes"] == 8
        outs.append(out)
    for out in outs[1:]:
        assert torch.equal(out["final_x"], outs[0]["final_x"])
        assert torch.equal(out["exit_code"], outs[0]["exit_code"])
