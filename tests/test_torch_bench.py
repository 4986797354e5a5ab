"""bench_torch.py, the port's benchmark entry, against bench.py and the JAX
package, on the CPU.

The flagship is built as bench.py builds it (its arrays to 1e-14) and run
on JAX-drawn plants (PRNGKey(0), bench.py's key) in float64 against the
JAX `HostLoopMPC` built with bench.py's own config on the CPU in x64 with
the XLA impls, in the carried-dual and the cold form: final states within
1e-9 (the ops agree to ~1e-13 a call; the plant steps differ by design,
bench.py's Taylor 16 with 4 squarings against the fleet's auto Taylor 12
with none, both exact to ~1e-15 at this norm), exit codes equal. The
preset table, the rescue settings and the JSON key order are read from
bench.py with `ast`; bench.py itself is loaded by importlib for its
baseline, never imported by the port.
"""

import ast
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax

import mpc4quantum_tpu as m4q
from mpc4quantum_tpu.models.dmdc import dmdc_from_operator as jax_dmdc
from mpc4quantum_tpu.mpc.hostloop import HostLoopMPC
from mpc4quantum_tpu.parallel.fleet import make_scenario_batch as jax_batch
from mpc4quantum_tpu.plants.quantum import quantum_step_taylor
from mpc4quantum_tpu.solvers.boxqp import BoxQPParams as JaxBoxQPParams

import bench_torch
from mpc4quantum_tpu_torch import presets
from mpc4quantum_tpu_torch.benchfleet import fleet_fidelity, make_runner, run_hostloop_fleet
from mpc4quantum_tpu_torch.convert import plant_from_numpy

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench)
BENCH_AST = ast.parse((ROOT / "bench.py").read_text())

B = 4
# bench.py's keys that name TPU dispatch forms or a TPU-era constant
LEFT_OUT = ("engine_path", "granularity", "compile_cache", "vs_baseline_quiet_r03")
UNSUPPORTED = ("BENCH_PATH", "BENCH_QP_IMPL", "BENCH_PLANT_IMPL", "BENCH_GRAN", "BENCH_FUSE",
               "BENCH_TRAJ", "BENCH_UNROLL", "BENCH_NO_PROBE", "BENCH_PROBE_TIMEOUT",
               "BENCH_TPU_TIMEOUT", "BENCH_NO_FALLBACK")
CPU_ENV = {"BENCH_DEVICE": "cpu", "BENCH_BATCH": str(B), "BENCH_REPS": "1",
           "BENCH_BASELINE_REPS": "1"}


def jax_flagship_arrays():
    """bench.py:271-291's calls, on the CPU in x64."""
    units = bench.matrix_units(2)
    A0 = m4q.vectorize_me(np.zeros((2, 2)), units)
    A1 = m4q.vectorize_me(0.5 * bench.SX, units)
    A_dst = np.asarray(m4q.discretize_homogeneous([A0, A1], bench.DT, bench.ORDER))
    model = jax_dmdc(A_dst, 4, 4, A_dst.shape[1] - 4)
    base = m4q.QuantumPlant.create(0.5 * (bench.WQ * 0.99 - bench.WQ) * bench.SZ,
                                   [0.5 * bench.SX])
    plants, keys = jax_batch(jax.random.PRNGKey(0), base, B, detune_scale=0.01)
    targ = np.zeros(4, complex)
    targ[3] = 1.0
    return dict(model=model, base=base, plants=plants, keys=keys, rho0=bench.perturbed_rho0(),
                targ=targ, X_targ=np.tile(targ[:, None], (1, bench.N_STEPS + bench.H + 1)),
                U_targ=np.zeros((1, bench.N_STEPS + bench.H)),
                Q=np.diag([1.0, 0, 0, 1]).astype(complex),
                R=np.eye(1) * (1e-2 / bench.SAT ** 2))


def jax_bench_run(a, warm_duals: bool) -> dict:
    """HostLoopMPC with bench.py:363-375's config and its CPU dispatch
    choices (XLA QP and plant, sqp granularity, fuse 1), default knobs."""
    kinv = "ns"
    cfg = m4q.MPCConfig(horizon=bench.H, n_steps=bench.N_STEPS, dt=bench.DT, dim_u=1,
                        order=bench.ORDER, qp_backend="ns", qp_warm_duals=warm_duals,
                        qp_params=JaxBoxQPParams(max_iter=12 if warm_duals else 15,
                                                 n_rounds=3, kinv=kinv))
    steady_qp = (JaxBoxQPParams(max_iter=10, n_rounds=2, accept_abs=4e-3, accept_rel=4e-3,
                                kinv=kinv) if warm_duals else None)
    runner = HostLoopMPC(cfg, bench.SAT, du=bench.DU, plant_step_fn=quantum_step_taylor,
                         warm_sqp_iters=(7, 1), qp_impl="xla", plant_impl="xla",
                         granularity="sqp", steady_fuse=1, steady_qp_params=steady_qp,
                         qp_kernel="auto")
    out = runner.run(a["rho0"], a["model"], a["plants"], a["X_targ"], a["U_targ"], a["Q"],
                     a["R"], a["Q"], a["keys"], record=False)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def reference():
    """The JAX flagship's arrays and plants, and bench.py's engine run on
    them in both forms (about 30 s of compile and run)."""
    a = jax_flagship_arrays()
    a["runs"] = {warm: jax_bench_run(a, warm) for warm in (True, False)}
    a["port_plants"] = plant_from_numpy(
        {k: np.asarray(getattr(a["plants"], k)) for k in ("H0", "H1s", "sigma")})
    return a


def port_flagship(reference, warm_duals: bool, dtype=torch.float64):
    sc, _ = bench_torch.flagship(B, "cpu", dtype, warm_duals=warm_duals)
    return sc, reference["port_plants"].to("cpu", dtype)


def test_flagship_build_matches_bench(reference):
    sc, plants = bench_torch.flagship(B, "cpu", torch.float64)
    close = lambda t, a: np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=0, atol=1e-14)
    close(sc.model.A, reference["model"].A)
    assert (sc.model.dim_y, sc.model.dim_x, sc.model.dim_u) == (4, 4, 8)
    close(sc.x0, reference["rho0"])
    close(sc.X_targ, reference["X_targ"])
    close(sc.U_targ, reference["U_targ"])
    close(sc.target_state, reference["targ"])
    close(sc.Q, reference["Q"])
    close(sc.Qf, reference["Q"])
    close(sc.R, reference["R"])
    for k in ("H0", "H1s", "sigma"):
        close(getattr(sc.plant, k), getattr(reference["base"], k))
    assert (sc.sat, sc.du) == (bench.SAT, bench.DU)
    c = sc.config
    assert (c.horizon, c.n_steps, c.dt, c.dim_u, c.order) == (bench.H, bench.N_STEPS, bench.DT,
                                                               1, bench.ORDER)
    # the lanes: the base drift scaled lane by lane, the drive untouched
    assert plants.lanes == B and plants.H0.dtype == torch.complex128
    scale = (plants.H0 / sc.plant.H0.expand_as(plants.H0))[:, 0, 0].real
    assert float((scale - 1).abs().max()) < 0.05 and len(set(scale.tolist())) == B
    assert torch.equal(plants.H1s, sc.plant.H1s.expand_as(plants.H1s))
    # presets.not_state's plant from RWAQubit is the same plant
    ns = presets.not_state(device="cpu", dtype=torch.float64)
    close(ns.plant.H0, reference["base"].H0)
    close(ns.model.A, reference["model"].A)


@pytest.mark.parametrize("warm_duals", [True, False], ids=["carried", "cold"])
def test_flagship_run_matches_jax_bench_engine(reference, warm_duals):
    sc, plants = port_flagship(reference, warm_duals)
    m, out = run_hostloop_fleet(sc, B, plants=plants, **bench_torch.flagship_overrides(sc))
    ref = reference["runs"][warm_duals]
    np.testing.assert_allclose(out["final_x"].numpy(), ref["final_x"], rtol=0, atol=1e-9)
    np.testing.assert_array_equal(out["exit_code"].numpy(), ref["exit_code"])
    fid_ref = np.real(ref["final_x"] @ np.conj(reference["targ"]))
    np.testing.assert_allclose(fleet_fidelity(sc, out["final_x"]), fid_ref,
                               rtol=0, atol=1e-9)
    assert m["completed_frac"] == 1.0 and fid_ref.min() > 0.998
    assert m["warm_budget"] == ("3x12" if warm_duals else "3x15")
    assert m["steady_budget"] == ("2x10" if warm_duals else "3x15")
    assert m["warm_duals"] is warm_duals and m["warm_sqp_iters"] == [7, 1]


@pytest.mark.parametrize("warm_duals", [True, False], ids=["carried", "cold"])
def test_flagship_runner_budgets(reference, warm_duals):
    """The explicit budgets reach the runner as bench.py gives them; cold,
    the steady steps run the warm program's 3x15 and carry no dual (JAX's
    HostLoopMPC with steady_qp_params=None)."""
    sc, plants = port_flagship(reference, warm_duals)
    runner = make_runner(sc, plants, **bench_torch.flagship_overrides(sc))
    warm, steady = runner.config.qp_params, runner.steady_qp_params
    assert runner.warm_sqp_iters == (7, 1) and runner.qp_kernel == "small"
    assert runner.carry_duals is warm_duals and runner.config.qp_backend == "ns"
    assert (warm.n_rounds, warm.max_iter, warm.kinv) == (3, 12 if warm_duals else 15, "ns")
    if warm_duals:
        assert (steady.n_rounds, steady.max_iter, steady.accept_abs, steady.accept_rel,
                steady.kinv) == (2, 10, 4e-3, 4e-3, "ns")
    else:
        assert steady is warm


def test_explicit_budgets_equal_the_preset_tables(reference):
    """bench.py's budgets passed explicitly give the run that benchfleet's
    not_state tables give, bit for bit, on the same plants."""
    sc, plants = port_flagship(reference, True)
    _, out = run_hostloop_fleet(sc, B, plants=plants, **bench_torch.flagship_overrides(sc))
    _, out_p = run_hostloop_fleet(presets.not_state(device="cpu", dtype=torch.float64), B,
                                  plants=plants)
    assert torch.equal(out["final_x"], out_p["final_x"])
    assert torch.equal(out["exit_code"], out_p["exit_code"])


def test_cpu_baseline_matches_bench():
    fid = bench_torch.cpu_baseline_rollout()
    assert abs(fid - bench.cpu_baseline_rollout()) <= 1e-12 and fid > 0.98


def _main_assign(name):
    for node in ast.walk(BENCH_AST):
        if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == name
                                                for t in node.targets):
            return node.value
    raise AssertionError(f"bench.py assigns no {name}")


def test_preset_spec_equals_bench():
    assert bench_torch.PRESET_SPEC == ast.literal_eval(_main_assign("preset_spec"))
    # cnot's rescue: bench.py's {"threshold": ..., "scenario": PRESETS[name](**kw)}
    rescues = {}
    for node in ast.walk(BENCH_AST):
        if isinstance(node, ast.If) and isinstance(node.test, ast.Compare) and \
                isinstance(node.test.comparators[0], ast.Constant):
            for d in ast.walk(node):
                if isinstance(d, ast.Dict) and any(isinstance(k, ast.Constant)
                                                   and k.value == "threshold" for k in d.keys):
                    fields = {k.value: v for k, v in zip(d.keys, d.values)}
                    kw = {k.arg: ast.literal_eval(k.value) for k in fields["scenario"].keywords}
                    rescues[node.test.comparators[0].value] = (
                        ast.literal_eval(fields["threshold"]), kw)
    assert bench_torch.PRESET_RESCUE == rescues == {"cnot_state": (0.99, {"order": 3})}
    # every preset: reps=4 and the key's seed 1
    calls = [c for c in ast.walk(BENCH_AST) if isinstance(c, ast.Call)
             and getattr(c.func, "id", None) == "run_hostloop_fleet"]
    (call,) = calls
    kw = {k.arg: k.value for k in call.keywords}
    assert bench_torch.PRESET_REPS == ast.literal_eval(kw["reps"])
    assert ast.literal_eval(kw["key"].args[0]) == 1


def bench_keys() -> list:
    """The keys of bench.py's out.update({...}), in order."""
    for node in ast.walk(BENCH_AST):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and \
                node.func.attr == "update" and getattr(node.func.value, "id", None) == "out":
            return [k.value for k in node.args[0].keys]
    raise AssertionError("bench.py has no out.update")


def expected_keys(on_card: bool) -> list:
    keys = [k for k in bench_keys() if k not in LEFT_OUT]
    at = keys.index("device") + 1
    return keys[:at] + ["dtype"] + (["power_limit"] if on_card else []) + keys[at:]


def last_json_line(capsys) -> dict:
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


def test_main_key_order_and_gates(capsys):
    out = bench_torch.main(env=dict(CPU_ENV))
    printed = last_json_line(capsys)
    assert printed == json.loads(json.dumps(out))
    assert list(printed) == expected_keys(on_card=False)
    assert printed["device"] == "cpu" and printed["dtype"] == "float32"
    assert printed["batch"] == B and printed["qp_impl"] == printed["plant_impl"] == "plain"
    assert printed["warm_duals"] is True and printed["qp_kernel"] == "auto"
    assert printed["warm_sqp_iters"] == [7, 1] and printed["metric"] == "mpc_rollouts_per_s"
    assert printed["fidelity_mean"] > 0.98 and printed["fidelity_min"] > 0.95
    assert printed["completed_frac"] >= 0.999 and printed["baseline_cpu_fidelity"] > 0.98
    assert printed["calib_chain_ms"] > 0 and printed["calib_dispatch_ms"] > 0


def test_preset_gate_failure_is_recorded(monkeypatch, capsys):
    monkeypatch.setattr(bench_torch, "PRESET_SPEC", {"lindblad_state": (4, {}, 1.01)})
    out = bench_torch.main(env={**CPU_ENV, "BENCH_PRESETS": "lindblad_state"})
    printed = last_json_line(capsys)
    assert list(printed)[:2] == ["presets", "preset_gates_ok"]
    assert list(printed)[2:] == expected_keys(on_card=False)
    assert printed["preset_gates_ok"] is False and out["preset_gates_ok"] is False
    entry = printed["presets"]["lindblad_state"]
    assert "fidelity_min" in entry["gate_failed"] and "1.01" in entry["gate_failed"]
    assert entry["batch"] == 4 and entry["timed_reps"] == bench_torch.PRESET_REPS - 1
    assert entry["completed_frac"] == 1.0


def test_preset_errors_propagate(monkeypatch, capsys):
    def broken(**kw):
        raise RuntimeError("preset construction failed")

    monkeypatch.setattr(bench_torch, "PRESET_SPEC", {"lindblad_state": (4, {}, 0.85)})
    monkeypatch.setitem(presets.PRESETS, "lindblad_state", broken)
    with pytest.raises(RuntimeError, match="preset construction failed") as err:
        bench_torch.main(env={**CPU_ENV, "BENCH_PRESETS": "lindblad_state"})
    assert type(err.value) is RuntimeError
    assert capsys.readouterr().out == ""


def test_no_card_exits_1_without_a_line():
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    proc = subprocess.run([sys.executable, "bench_torch.py"], capture_output=True, text=True,
                          timeout=120, cwd=ROOT, env=env)
    assert proc.returncode == 1 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr


@pytest.mark.parametrize("knob", UNSUPPORTED)
def test_unsupported_knob_is_refused(knob, capsys):
    with pytest.raises(SystemExit) as err:
        bench_torch.main(env={**CPU_ENV, knob: "1"})
    assert err.value.code not in (0, None)
    captured = capsys.readouterr()
    assert knob in captured.err and captured.out == ""


def test_every_bench_knob_is_read_or_refused():
    read = {n.args[0].value for n in ast.walk(BENCH_AST) if isinstance(n, ast.Call)
            and getattr(n.func, "attr", None) == "get" and n.args
            and isinstance(n.args[0], ast.Constant) and str(n.args[0].value).startswith("BENCH_")}
    source = (ROOT / "bench_torch.py").read_text()
    supported = {k for k in read if f'"{k}"' in source} - set(UNSUPPORTED)
    assert set(bench_torch.UNSUPPORTED) == set(UNSUPPORTED) == read - supported
    assert supported == {"BENCH_BATCH", "BENCH_REPS", "BENCH_DEVICE", "BENCH_WARM_DUALS",
                         "BENCH_WARM_ITERS", "BENCH_QP_KERNEL", "BENCH_KINV", "BENCH_PRESETS",
                         "BENCH_BASELINE_REPS"}


def test_device_calibration_on_cpu():
    chain_ms, disp_ms = bench_torch.device_calibration(torch.device("cpu"), reps=1)
    assert chain_ms > 0 and disp_ms >= 0


def test_import_loads_no_jax():
    code = ("import sys, bench_torch; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', "
            "'mpc4quantum_tpu.')) or m in ('mpc4quantum_tpu', 'bench')]; print(bad); "
            "sys.exit(bool(bad))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
