"""CPU tests of the benchmark's harness (benchmark/): each cell end to end at
a tiny size, the result's keys, the imports, cells found by their files,
the frozen work formulas, the trace reduction, the plain reference
against the program in float64, and the comparison failing the TF32
control and the faults a fleet can have.

    python -m pytest benchmark/tests -q

The tests marked `cuda` run one cell on the card and skip elsewhere.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import check, devtrace, readings, spec, work  # noqa: E402
from benchmark import run as bench_run  # noqa: E402
from benchmark.reference import mpc_plain as ref  # noqa: E402

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
# lanes (or pool plants) of a cell's tiny CPU run
TINY = {"fleet": 4, "rollout": 2}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def tiny_run(name: str, seed: int = 2 ** 31 + 11, **kw) -> dict:
    cell = spec.load_cell(name)
    return bench_run.run(cell, seed, 0.05, False, device="cpu", size=TINY[cell.entry], **kw)


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_cpu(name):
    res = tiny_run(name)
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    cell = spec.load_cell(name)
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    json.loads(json.dumps(res))


def test_run_loads_no_jax():
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            "from benchmark import run, spec; "
            "run.run(spec.load_cell('not_state.b16384'), 5, 0.01, False, device='cpu', size=2); "
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert "mpc4quantum_tpu_torch" not in bench_run.FORBIDDEN
    assert bench_run.forbidden_modules.__doc__


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_imports():
    bench = ROOT / "benchmark"
    for path in bench.rglob("*.py"):
        if "tests" in path.parts:
            continue
        bad = _imports(path) & {"jax", "jaxlib", "flax", "mpc4quantum_tpu", "bench",
                                "bench_torch", "chip_smoke", "perf_fleets"}
        assert not bad, (path, bad)
    for path in (bench / "reference").glob("*.py"):
        assert "mpc4quantum_tpu_torch" not in _imports(path), path


def test_new_cell_is_found_by_its_file(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "cnot_state.b64", "config": "cnot_state",
                               "traffic": "fleet_b64", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "benchmark" / "traffic" / "fleet_b64.json").write_text(
        json.dumps({"entry": "fleet", "lanes": 64, "traced_runs": 1}))
    (tmp_path / "benchmark" / "workloads" / "cnot_state.b64.json").write_text(
        json.dumps({"config": "cnot_state", "traffic": "fleet_b64", "why": "a test"}))
    cell = spec.load_cell("cnot_state.b64", root=tmp_path)
    assert cell.traffic["lanes"] == 64 and cell.config["name"] == "cnot_state"
    assert {m["name"] for m in cell.end_to_end} == {"setup_s"}
    with pytest.raises(FileNotFoundError):
        spec.load_cell("cnot_state.b32", root=tmp_path)


@pytest.mark.parametrize("shape", [(16384, 10, 12, 3), (1024, 15, 10, 2), (7, 4, 150, 1)])
def test_frozen_work_equals_the_program(shape):
    from mpc4quantum_tpu_torch.kernels import admm_big, boxqp, expm

    B, n, iters, rounds = shape
    for warm in (True, False):
        assert work.boxqp_small_work(B, n, iters, rounds, y0=warm, rho0=warm) == \
            boxqp.boxqp_small_work(B, n, iters, rounds, y0=warm, rho0=warm)
    assert work.admm_big_work(B, 10 * n, iters) == admm_big.admm_big_work(B, 10 * n, iters)
    assert work.stream_bytes(B, 10 * n, iters) == admm_big.stream_bytes(B, 10 * n, iters)
    for d, k, s in ((2, 12, 0), (16, 12, 1), (n, 18, rounds)):
        assert work.expm_small_work(B, d, k, s) == expm.expm_small_work(B, d, k, s)
    consts = {t.id: node.value.value for node in ast.parse((ROOT / "chip_smoke.py").read_text()).body
              if isinstance(node, ast.Assign) for t in node.targets
              if isinstance(t, ast.Name) and t.id in ("PEAK_FLOPS", "PEAK_BYTES")}
    assert consts == {"PEAK_FLOPS": work.PEAK_FLOPS, "PEAK_BYTES": work.PEAK_BYTES}


def test_schedule_counts_the_launches():
    cfg = spec.load_cell("not_state.b16384").config
    launches, flops, nbytes = work.qp_schedule(cfg, [16384])["qp_small"]
    assert launches == 26  # 7 + 1 warm solves, 18 steady
    cnot = spec.load_cell("cnot_state.b1024").config
    assert work.qp_schedule(cnot, [1024])["qp_admm"][0] == 222  # 8 x 3 rounds + 198


def test_trace_reduction():
    ev = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 100, "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "inner", "ts": 60, "dur": 20, "tid": 1},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1, "dur": 1},
          {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernelEx", "ts": 2, "dur": 1},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 3, "dur": 1},
          {"ph": "X", "cat": "kernel", "name": "void boxqp_small_kernel<10>(float*)", "ts": 20,
           "dur": 30},
          {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 40, "dur": 20},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pageable)", "ts": 90,
           "dur": 10}]
    flops, nbytes = work.boxqp_small_work(1, 10, 12, 3)
    s = devtrace.reduce(ev, 2e-4, spec.kernel_map(), entry="fleet", steps=2, rollouts=1,
                        schedule={"qp_small": (1, flops, nbytes)})
    assert s.busy_s == pytest.approx(50e-6) and s.runtime_calls == 2 and s.syncs == 2
    assert s.idle_gaps == [["inner", pytest.approx(30e-6)]]
    read = lambda m: spec.metric_reader(m)(s)
    assert read("runtime_calls_per_step.fleet") == 1.0
    assert read("plain_ops_ms_per_step.fleet") == pytest.approx(0.015)
    assert read("device_idle_pct.fleet") == pytest.approx(75.0)
    assert read("syncs_per_rollout.rollout") is None
    assert read("qp_small.roofline_pct") == pytest.approx(100 * work.bound_s(flops, nbytes) / 30e-6)
    assert read("qp_admm.roofline_pct") is None
    s.schedule = {"qp_small": (2, flops, nbytes)}  # another schedule than the one run
    assert read("qp_small.roofline_pct") is None


def _lanes(sc, eps, dtype):
    from benchmark import drive

    return drive.lane_plants(sc.plant.to("cpu", torch.float64), eps, "cpu", dtype)


@pytest.mark.parametrize("name,lanes,steps", [("not_state", 4, 20), ("cnot_state", 2, 12)])
def test_reference_matches_the_program_in_float64(name, lanes, steps):
    from mpc4quantum_tpu_torch import presets
    from mpc4quantum_tpu_torch.benchfleet import make_runner

    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    eps = np.array([0.012, -0.004, 0.0, 0.02][:lanes])
    sc = presets.PRESETS[name](**cfg["program"]["kwargs"], device="cpu", dtype=torch.float64)
    sc = dataclasses.replace(sc, config=dataclasses.replace(sc.config, n_steps=steps))
    plants = _lanes(sc, eps, torch.float64)
    out = make_runner(sc, plants).run(sc.x0, sc.model, plants, sc.X_targ, sc.U_targ, sc.Q, sc.R,
                                      sc.Qf, record=True)
    r = ref.closed_loop(spec.reference_problem(cfg), ref.LoopBudget.from_dict(
        cfg["budgets"]["fleet"]), eps, ref.Arith("float64"), record=True, n_steps=steps)
    assert float((out["xs"] - r["xs"]).abs().max()) < 1e-10
    assert float((out["us"] - r["us"]).abs().max()) < 1e-10
    assert torch.equal(out["exit_code"].long(), r["exit_code"])


@pytest.mark.parametrize("name", ["not_state.b16384", "not_state.rollout_b1"])
def test_the_control_is_not_correct(name):
    cell = spec.load_cell(name)
    n = TINY[cell.entry]
    for seed in (1, 2, 3):
        eps, outs = readings.control_outputs(cell, seed, "cpu", n)
        ok, rows = check.verdict(check.compare(cell.config, cell.entry, eps, outs, "cpu"),
                                 cell.config["limits"][cell.entry])
        assert not ok, rows


def _broken(monkeypatch, fault: str):
    """Break the program's timed path underneath the harness."""
    from mpc4quantum_tpu_torch.mpc import fleet_runner
    from mpc4quantum_tpu_torch.plants.quantum import QuantumPlant
    from mpc4quantum_tpu_torch.solvers import condense

    if fault == "state_unchanged":
        monkeypatch.setattr(QuantumPlant, "step", lambda self, x, u, *a, **k: x)
    elif fault == "half_the_lanes":
        run = fleet_runner.FleetRunner.run

        def half(self, x0, model, plants, *a, **k):
            B = plants.lanes
            out = run(self, x0, model, plants[: max(B // 2, 1)], *a, **k)
            rep = lambda t: torch.cat([t, t])[:B] if B > 1 else t
            return {key: rep(v) if torch.is_tensor(v) and v.dim() and v.shape[0] == max(B // 2, 1)
                    else v for key, v in out.items()}
        monkeypatch.setattr(fleet_runner.FleetRunner, "run", half)
    elif fault == "answer_altered":
        qp = condense.quad_program

        def altered(*a, **k):
            res = qp(*a, **k)
            U = res.U.clone()
            U[0, 0, 0] += 1e-2
            return res._replace(U=U)
        monkeypatch.setattr(fleet_runner, "quad_program", altered)


@pytest.mark.parametrize("name,fault", [
    ("not_state.b16384", "state_unchanged"), ("not_state.b16384", "half_the_lanes"),
    ("not_state.b16384", "answer_altered"), ("not_state.rollout_b1", "state_unchanged"),
    ("not_state.rollout_b1", "answer_altered")])  # a rollout is one lane: no half to leave out
def test_a_broken_run_is_not_correct(monkeypatch, name, fault):
    _broken(monkeypatch, fault)
    res = tiny_run(name)
    assert res["correct"] is False, res["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["not_state.b16384", "not_state.rollout_b1"])
def test_cell_on_the_card(card, name):
    cell = spec.load_cell(name)
    res = bench_run.run(cell, 12345, 0.5, False, device=card, size=64)
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["memory_peak_bytes"] > 0
