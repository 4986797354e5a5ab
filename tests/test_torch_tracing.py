"""The port's span recorder (utils/profiling.spans) and the benchmark's
readers of it (benchmark/metrics/_spans.py and the readers that use it),
on the CPU; imports no JAX.

Off (no torch.profiler recording), a fleet run and an `mpc()` call leave
no record and open no record_function range. On, every span name is in
the Chrome trace as a user_annotation nested under fleet.run, the in-memory
records chain to their run's fleet.run, and the outputs are equal to an
untraced run's. The readers take only the last of two traced windows,
read nothing where the imported program has no recorder, and give a number
in the cells BENCHMARK.json lists for them and nothing elsewhere (the
event-timed ones nothing on the CPU, a number with events put in). The
trace's reduction is the same with the spans as without them.
"""

import dataclasses
import json
import sys
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import devtrace, drive, spec  # noqa: E402
from benchmark.metrics import _spans  # noqa: E402
from mpc4quantum_tpu_torch import mpc, presets  # noqa: E402
from mpc4quantum_tpu_torch.benchfleet import make_runner  # noqa: E402
from mpc4quantum_tpu_torch.parallel.fleet import make_scenario_batch  # noqa: E402
from mpc4quantum_tpu_torch.utils import profiling  # noqa: E402
from mpc4quantum_tpu_torch.utils.profiling import spans  # noqa: E402

NAMES = ("fleet.run", "fleet.step", "sqp.iter", "sqp.linearize", "qp.condense", "qp.kinv",
         "plant.step", "host.flag")
EVENT_SPANS = ("sqp.linearize", "qp.condense", "qp.kinv", "plant.step")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
# the per-layer metrics read from the spans, and the ones of them timed by events
SPAN_METRICS = [m for m in BENCH["per_layer"]
                if "_spans" in (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").read_text()]
EVENT_TIMED = ("model_stream_ms_per_step.fleet", "kinv_stream_ms_per_step.fleet",
               "plant_stream_ms_per_step.fleet")
# the readers of the steps' graph attribute: off the card every step is eager
GRAPH_METRICS = ("graph_replay_pct.fleet", "graph_replay_pct.rollout")
# the readers of the condensing's and the K^-1's route attribute: off the card
# every one is plain
ROUTE_METRICS = ("condense_kernel_pct.fleet", "kinv_kernel_pct.fleet")
# the readers of qp.kinv, which off the card the plain boxqp_small opens too
KINV_METRICS = ("kinv_stream_ms_per_step.fleet", "kinv_kernel_pct.fleet")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module: under `-n 6` each test process's
    own pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def flagship_work():
    """A flagship fleet of 4 lanes on the boxqp_big route (so each span
    site runs: qp.kinv is the big route's K^-1), then one `mpc()` call on
    the kernel route (its done-flag reads): outputs as a list of tensors."""
    sc = presets.not_state(device="cpu")
    plants = make_scenario_batch(sc.plant, 4, generator=torch.Generator().manual_seed(1))
    runner = make_runner(sc, plants, qp_kernel="big")
    args = {**sc.mpc_args(), "config": dataclasses.replace(sc.config, qp_backend="ns")}

    def work():
        out = runner.run(sc.x0, sc.model, plants, sc.X_targ, sc.U_targ, sc.Q, sc.R, sc.Qf,
                         record=True)
        res = mpc(**args)
        return [out["final_x"], out["exit_code"], out["xs"], out["us"], res.xs, res.us,
                res.sqp_iters]

    return work


def traced(work, tmp_path: Path):
    """(work's result, the window's Chrome trace events, window seconds),
    the window timed as devtrace.profile times it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        result = work()
        window_s = time.perf_counter() - t0
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return result, json.loads(path.read_text())["traceEvents"], window_s


def test_off_records_nothing(monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counting(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    before, reads = list(spans.runs), profiling.host_flag.reads
    flagship_work()()
    assert list(spans.runs) == before and not spans.on and not spans.open
    assert calls == []
    # the flag reads are still counted
    assert profiling.host_flag.reads > reads


def test_on_every_span_in_the_trace(tmp_path):
    work = flagship_work()
    plain = work()
    out, events, _ = traced(work, tmp_path)
    assert all(torch.equal(a, b) for a, b in zip(plain, out))
    ann = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    assert {e["name"] for e in ann} >= set(NAMES)
    runs = [e for e in ann if e["name"] == "fleet.run"]
    assert len(runs) == 2
    for e in ann:
        if e["name"] != "fleet.run":
            assert any(r["tid"] == e["tid"] and r["ts"] <= e["ts"]
                       and e["ts"] + e["dur"] <= r["ts"] + r["dur"] for r in runs), e["name"]
    # the records: each chains to its run's fleet.run; nothing carries events off the card
    fleet, rollout = spans.runs[-2], spans.runs[-1]
    for run in (fleet, rollout):
        root = run[0]
        assert root.name == "fleet.run" and root.parent is None
        for sp in run[1:]:
            assert sp.run == root.run and sp.events is None
            assert root.start_ns <= sp.start_ns <= sp.end_ns <= root.end_ns
            top = sp
            while top.parent is not None:
                top = top.parent
            assert top is root
    steps = [sp for sp in fleet if sp.name == "fleet.step"]
    assert [sp.attrs["phase"] for sp in steps] == ["warm"] * 2 + ["steady"] * 18
    assert {sp.parent.name for sp in fleet if sp.name == "qp.kinv"} == {"sqp.iter"}
    assert {sp.parent.name for sp in fleet if sp.name == "plant.step"} == {"fleet.step"}
    assert not any(sp.name == "host.flag" for sp in fleet)
    assert any(sp.name == "host.flag" for sp in rollout)
    assert not spans.on and not spans.open


def test_helper_takes_the_last_window(tmp_path, monkeypatch):
    sc = presets.not_state(device="cpu")
    plants = make_scenario_batch(sc.plant, 2, generator=torch.Generator().manual_seed(2))
    runner = make_runner(sc, plants)
    args = {**sc.mpc_args(), "config": dataclasses.replace(sc.config, qp_backend="ns")}
    fleet_run = lambda: runner.run(sc.x0, sc.model, plants, sc.X_targ, sc.U_targ, sc.Q, sc.R,
                                   sc.Qf)
    traced(lambda: [fleet_run() for _ in range(2)], tmp_path)
    first = {run[0].run for run in list(spans.runs)[-2:]}
    _, _, window_s = traced(lambda: mpc(**args), tmp_path)
    s = devtrace.Summary(entry="rollout", steps=20, rollouts=1, window_s=window_s, busy_s=0.0,
                         runtime_calls=0, syncs=0, fn_device_s={}, fn_launches={}, schedule={},
                         device_ops=[], idle_gaps=[])
    recs = _spans.records(s)
    assert {sp.run for sp in recs} == {spans.runs[-1][0].run}
    assert not {sp.run for sp in recs} & first
    assert recs == spans.runs[-1]
    # a program without the recorder (the parent commit): every reader reads nothing
    monkeypatch.delattr(profiling, "spans")
    assert _spans.records(s) is None
    for m in SPAN_METRICS:
        assert spec.metric_reader(m["name"])(s) is None


def test_reduce_ignores_the_spans(tmp_path):
    _, events, window_s = traced(flagship_work(), tmp_path)
    assert any(e.get("cat") == "user_annotation" for e in events)
    # device activity and runtime calls around and inside the spans, as on the card
    t0 = min(float(e["ts"]) for e in events if e.get("cat") == "user_annotation")
    dev = [{"ph": "X", "cat": "kernel", "name": "k", "ts": t0 + 10.0 * i, "dur": 3.0,
            "tid": 7} for i in range(50)]
    rt = [{"ph": "X", "cat": "cuda_runtime", "name": n, "ts": t0 + 10.0 * i + 1, "dur": 1.0}
          for i, n in enumerate(["cudaLaunchKernel", "cudaStreamSynchronize"] * 10)]
    spanless = [e for e in events if e.get("cat") != "user_annotation"]
    kw = dict(entry="fleet", steps=20, rollouts=1, schedule={})
    a = devtrace.reduce(events + dev + rt, window_s, spec.kernel_map(), **kw)
    b = devtrace.reduce(spanless + dev + rt, window_s, spec.kernel_map(), **kw)
    assert (a.runtime_calls, a.syncs, a.busy_s) == (b.runtime_calls, b.syncs, b.busy_s)
    assert a.runtime_calls == 10 and a.syncs == 10 and a.busy_s > 0
    assert a.idle_gaps == b.idle_gaps and len(a.idle_gaps) == 10
    assert not any(label in NAMES for label, _ in a.idle_gaps)


class FakeEvent:
    """A CUDA event stand-in: elapsed_time as the difference of two stamps."""

    def __init__(self, ms: float):
        self.ms = ms

    def elapsed_time(self, end: "FakeEvent") -> float:
        return end.ms - self.ms


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    """{cell: (readings off the card, readings with every event span given
    events 0.5 ms apart, the span records)} of a tiny traced window of each
    cell, read right after it: the harness's sessions (benchmark/drive.py)
    at 4 lanes (cnot 2) or 2 rollouts."""
    out = {}
    for cell_name in CELLS:
        cell = spec.load_cell(cell_name)
        if cell.entry == "fleet":
            session = drive.Fleet(cell.config, 2 if cell.config["name"] == "cnot_state" else 4,
                                  3, "cpu")
            n = 1
        else:
            session = drive.Rollouts(cell.config, 2, 3, "cpu")
            n = 2
        _, events, window_s = traced(lambda: [session.run() for _ in range(n)],
                                     tmp_path_factory.mktemp(cell_name))
        s = devtrace.reduce(events, window_s, spec.kernel_map(), entry=cell.entry,
                            steps=n * session.n_steps, rollouts=n, schedule={})
        read = lambda: {m["name"]: spec.metric_reader(m["name"])(s) for m in SPAN_METRICS}
        off_card = read()
        recs = _spans.records(s)
        for sp in recs:
            if sp.name in EVENT_SPANS:
                sp.events = (FakeEvent(1.0), FakeEvent(1.5))
        out[cell_name] = (off_card, read(), recs)
    return out


def test_readers_read_their_cells(readings):
    assert len(SPAN_METRICS) == 10
    for m in SPAN_METRICS:
        for cell_name in CELLS:
            off_card, timed, _ = readings[cell_name]
            listed = cell_name in m["workloads"]
            if m["name"] in EVENT_TIMED:
                assert off_card[m["name"]] is None, (m["name"], cell_name)
                value = timed[m["name"]]
            else:
                value = off_card[m["name"]]
            if listed and m["name"] in GRAPH_METRICS + ROUTE_METRICS:
                assert value == 0.0, (m["name"], cell_name)
            elif listed:
                assert value is not None and value > 0, (m["name"], cell_name)
            elif m["name"] not in KINV_METRICS:
                assert value is None, (m["name"], cell_name)
    # off the card the plain boxqp_small builds its K^-1 in torch (a qp.kinv
    # span); on the card the kernel does, and no cell but cnot has the span
    _, timed, _ = readings["not_state.rollout_b1"]
    assert timed["kinv_stream_ms_per_step.fleet"] is None
    assert timed["kinv_kernel_pct.fleet"] is None


def test_reader_arithmetic(readings):
    count = lambda recs, *names: sum(sp.name in names for sp in recs)
    _, timed, recs = readings["cnot_state.b1024"]
    steps = count(recs, "fleet.step")
    assert steps == 200
    assert timed["model_stream_ms_per_step.fleet"] == pytest.approx(
        0.5 * count(recs, "sqp.linearize", "qp.condense") / steps)
    assert timed["kinv_stream_ms_per_step.fleet"] == pytest.approx(
        0.5 * count(recs, "qp.kinv") / steps)
    assert timed["plant_stream_ms_per_step.fleet"] == pytest.approx(0.5)
    host = [sp.end_ns - sp.start_ns for sp in recs if sp.name == "fleet.step"]
    assert timed["step_host_ms.fleet"] == pytest.approx(sum(host) / len(host) * 1e-6)
    _, timed, recs = readings["not_state.rollout_b1"]
    assert timed["sqp_iters_per_rollout.rollout"] == count(recs, "sqp.iter") / 2
    flags = sum(sp.end_ns - sp.start_ns for sp in recs if sp.name == "host.flag")
    assert timed["flag_wait_ms_per_rollout.rollout"] == pytest.approx(flags * 1e-6 / 2)


def test_fleet_step_graph_attribute_on_the_cpu(tmp_path):
    """Off the card every step runs eagerly: the attribute graph "eager"."""
    _, _, _ = traced(flagship_work(), tmp_path)
    fleet, rollout = spans.runs[-2], spans.runs[-1]
    for run in (fleet, rollout):
        steps = [sp for sp in run if sp.name == "fleet.step"]
        assert len(steps) == 20
        assert {sp.attrs["graph"] for sp in steps} == {"eager"}


def test_kinv_span_names_the_route(tmp_path, monkeypatch):
    """qp.kinv's attribute route: "plain" off the card; "kernel" where
    boxqp_big's cold chain goes to ns_cold (a stand-in that fits any K and
    runs the plain chain), with the same outputs; the rollout's boxqp_small
    (its Gauss-Jordan K^-1 in torch off the card) stays "plain"."""
    from mpc4quantum_tpu_torch.kernels import boxqp as boxqp_mod
    from mpc4quantum_tpu_torch.solvers.boxqp import _ns_inverse

    plain, _, _ = traced(flagship_work(), tmp_path)
    routes = lambda run: {sp.attrs["route"] for sp in run if sp.name == "qp.kinv"}
    assert routes(spans.runs[-2]) == routes(spans.runs[-1]) == {"plain"}
    calls = []

    def stand_in(K, iters):
        calls.append(iters)
        return _ns_inverse(K, iters)[0]
    stand_in.fits = lambda K: True
    monkeypatch.setattr(boxqp_mod, "ns_cold", stand_in)
    out, _, _ = traced(flagship_work(), tmp_path)
    kinv = [sp for sp in spans.runs[-2] if sp.name == "qp.kinv"]
    assert {sp.attrs["route"] for sp in kinv} == {"kernel"} and len(calls) == len(kinv) > 0
    assert routes(spans.runs[-1]) == {"plain"}
    for a, b in zip(out, plain):
        assert torch.equal(a, b)


def planted(graphs):
    """A window of one run whose fleet.step spans carry the attribute graph
    of each entry of `graphs` (None: no attribute), read through the
    benchmark's span helper."""
    run = [profiling.Span(spans, "fleet.run", False, None)]
    run[0].start_ns, run[0].end_ns = 1, 10 ** 9
    for k, g in enumerate(graphs):
        sp = profiling.Span(spans, "fleet.step", False,
                            {"phase": "steady"} if g is None else {"phase": "steady", "graph": g})
        sp.start_ns, sp.end_ns = 2 + k, 3 + k
        run.append(sp)
    return run


@pytest.mark.parametrize("graphs, pct", [(["replay"] * 20, 100.0),
                                         (["capture"] * 3 + ["replay"] * 17, 85.0),
                                         (["eager"] * 2 + ["replay"] * 6, 75.0),
                                         ([None] * 20, None)])
def test_graph_replay_readers(monkeypatch, graphs, pct):
    monkeypatch.setattr(spans, "runs", [planted(graphs)])
    for entry, name in (("fleet", "graph_replay_pct.fleet"),
                        ("rollout", "graph_replay_pct.rollout")):
        s = devtrace.Summary(entry=entry, steps=20, rollouts=1, window_s=1.0, busy_s=0.0,
                             runtime_calls=0, syncs=0, fn_device_s={}, fn_launches={},
                             schedule={}, device_ops=[], idle_gaps=[])
        assert spec.metric_reader(name)(s) == pct, name
        other = "rollout" if entry == "fleet" else "fleet"
        assert spec.metric_reader(name)(dataclasses.replace(s, entry=other)) is None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_timed_spans_on_a_captured_run(cuda, tmp_path):
    """A fleet whose steps replay graphs captured in an untraced run: its
    traced steps are replays, and the timed spans still read stream times."""
    sc = presets.not_state(device=cuda)
    plants = make_scenario_batch(sc.plant, 64, generator=torch.Generator().manual_seed(1))
    runner = make_runner(sc, plants, qp_kernel="big")
    go = lambda: runner.run(sc.x0, sc.model, plants, sc.X_targ, sc.U_targ, sc.Q, sc.R, sc.Qf,
                            record=True)
    plain = go()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out = go()
        torch.cuda.synchronize()
    assert torch.equal(out["final_x"], plain["final_x"])
    run = spans.runs[-1]
    steps = [sp for sp in run if sp.name == "fleet.step"]
    assert len(steps) == 20 and {sp.attrs["graph"] for sp in steps} == {"replay"}
    timed = [sp for sp in run if sp.name in EVENT_SPANS]
    assert {sp.name for sp in timed} == set(EVENT_SPANS)
    assert all(sp.stream_ms() > 0 for sp in timed)
    assert sum(sp.name == "sqp.iter" for sp in run) == 7 + 1 + 18
