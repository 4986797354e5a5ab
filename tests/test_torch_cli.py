"""The port's persistence, profiling and command line on the CPU:
`utils.checkpoint` (the round trip of complex model trees, ModelHistory),
the fleet runner's mid-run checkpoint and resume (mirroring the JAX
package's tests/test_hostloop_ckpt.py: a run that crashes after a
checkpoint and is called again returns exactly what the uninterrupted run
returns, the record included; a completed run deletes its checkpoint;
resume=False starts cold), `utils.profiling.profile_trace`, and `python -m
mpc4quantum_tpu_torch` in each mode: its JSON keys are those of the JAX
CLI (read from the JAX package's source), its single rollout's values
those of JAX `mpc(**scenario.mpc_args())` on the same preset (fidelity
within 1e-5, the CLI's rounding; exit code, n_valid and mean SQP
iterations equal).
"""

import ast
import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import jax

import mpc4quantum_tpu as m4q
from mpc4quantum_tpu import presets as jpresets

from mpc4quantum_tpu_torch import mpc, presets
from mpc4quantum_tpu_torch.__main__ import main
from mpc4quantum_tpu_torch.benchfleet import make_runner
from mpc4quantum_tpu_torch.models import dmdc as td
from mpc4quantum_tpu_torch.mpc import fleet_runner
from mpc4quantum_tpu_torch.mpc.driver import Carry
from mpc4quantum_tpu_torch.parallel.fleet import make_scenario_batch
from mpc4quantum_tpu_torch.utils.checkpoint import (ModelHistory, restore_checkpoint,
                                                    save_checkpoint)
from mpc4quantum_tpu_torch.utils.profiling import profile_trace

JAX_PACKAGE = Path(m4q.__file__).parent


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module: under `-n 6` each test process's
    own pool oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# utils.checkpoint and utils.profiling
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_complex_tree(tmp_path):
    rng = np.random.default_rng(0)
    A = torch.tensor(rng.normal(size=(3, 5)) + 1j * rng.normal(size=(3, 5)))
    m = td.online_from_bootstrap(A, 3, 3, 2, alpha=10.0)
    carry = Carry(*(torch.tensor(rng.normal(size=(2, 3))) for _ in range(5)),
                  torch.tensor([0, 2], dtype=torch.int32), torch.tensor([False, True]))
    tree = {"model": m, "carry": carry, "none": None, "pair": (torch.tensor(3), [A.real])}
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, tree)
    like = {"model": td.online_from_bootstrap(torch.zeros_like(A), 3, 3, 2),
            "carry": Carry(*(torch.zeros_like(t) for t in carry)), "none": None,
            "pair": (torch.tensor(0), [torch.zeros(3, 5, dtype=torch.float64)])}
    back = restore_checkpoint(path, like)
    assert torch.equal(back["model"].A, m.A) and torch.equal(back["model"].P, m.P)
    assert back["model"].A.dtype == torch.complex128 and back["model"].dim_x == m.dim_x
    assert all(torch.equal(a, b) for a, b in zip(back["carry"], carry))
    assert isinstance(back["carry"], Carry) and back["none"] is None
    assert int(back["pair"][0]) == 3 and torch.equal(back["pair"][1][0], A.real)
    assert not os.path.exists(path + ".tmp")
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(path, {"model": like["model"]})
    wrong = dict(like, pair=(torch.tensor(0), [torch.zeros(2, 5, dtype=torch.float64)]))
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(path, wrong)


def test_model_history_cadence():
    m = td.online_from_bootstrap(torch.zeros((2, 4), dtype=torch.complex128), 2, 2, 2)
    hist = ModelHistory(every=3)
    for i in range(10):
        m = td.online_fit_iteration(m, torch.ones(2, dtype=torch.complex128) * i,
                                    torch.ones(2, dtype=torch.complex128),
                                    torch.ones(2, dtype=torch.complex128))
        hist.record(m)
    assert len(hist) == 3  # at counts 3, 6, 9
    assert hist.snapshots[0].A.device.type == "cpu"
    assert not torch.equal(hist.snapshots[0].A, hist.snapshots[2].A)


def test_profile_trace_carries_the_spans(tmp_path):
    """The operator's exporter: off with no directory; on, its Chrome trace
    holds an `mpc()` call's spans, under one fleet.run."""
    with profile_trace(None) as prof:
        assert prof is None
    args = presets.not_state(device="cpu").mpc_args()
    with profile_trace(str(tmp_path / "trace")) as prof:
        res = mpc(**args)
    assert int(res.exit_code) == 0
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert names.count("fleet.run") == 1
    assert {"fleet.step", "sqp.iter", "qp.condense", "plant.step", "host.flag"} <= set(names)


# ---------------------------------------------------------------------------
# fleet runner checkpoint / resume
# ---------------------------------------------------------------------------


def ckpt_problem(kind: str, n_steps: int = 8):
    """The flagship on 4 CPU lanes, cut to n_steps, through the preset's
    tuned runner (carried duals: they must persist too); "streaming": a
    per-lane OnlineDMDc refit under noise at sigma 1e-5 drawn by a
    generator (the models and the noise must persist)."""
    sc = presets.not_state(device="cpu")
    sc = dataclasses.replace(sc, config=dataclasses.replace(sc.config, n_steps=n_steps))
    plants = make_scenario_batch(sc.plant, 4, generator=torch.Generator().manual_seed(1))
    run_kw = {}
    if kind == "streaming":
        A = sc.model.A
        sc = dataclasses.replace(sc, model=td.online_from_bootstrap(A, 4, 4, A.shape[1] - 4,
                                                                     alpha=1e2),
                                 config=dataclasses.replace(sc.config, streaming=True))
        plants = dataclasses.replace(plants, sigma=plants.sigma + 1e-5)
        run_kw = dict(model_update_fn=td.online_fit_iteration)
    runner = make_runner(sc, plants)
    args = (sc.x0, sc.model, plants, sc.X_targ, sc.U_targ, sc.Q, sc.R, sc.Qf)

    def run(**kw):
        if kind == "streaming":
            kw["generator"] = torch.Generator().manual_seed(7)
        return runner.run(*args, **run_kw, **kw)
    return run


def crash_at(monkeypatch, call: int):
    """Make the fleet runner's advance raise at its `call`-th call."""
    orig = fleet_runner.advance
    calls = {"n": 0}

    def dropping(*a, **k):
        calls["n"] += 1
        if calls["n"] == call:
            raise RuntimeError("simulated crash")
        return orig(*a, **k)
    monkeypatch.setattr(fleet_runner, "advance", dropping)
    return lambda: monkeypatch.setattr(fleet_runner, "advance", orig)


def assert_same(out_a, out_b, record):
    keys = ("final_x", "exit_code") + (("xs", "us", "objs", "sqp_iters", "n_valid")
                                       if record else ())
    for k in keys:
        assert torch.equal(out_a[k], out_b[k]), k
    assert torch.equal(out_a["model_state"].A, out_b["model_state"].A)


@pytest.mark.parametrize("kind,record", [("tuned", True), ("tuned", False),
                                         ("streaming", True)])
def test_crash_resume_equals_uninterrupted(tmp_path, monkeypatch, kind, record):
    run = ckpt_problem(kind)
    full = run(record=record)
    ckpt = str(tmp_path / "fleet.npz")
    restore = crash_at(monkeypatch, 6)  # steps 0-4 complete, the crash at 5
    with pytest.raises(RuntimeError, match="simulated crash"):
        run(record=record, checkpoint_path=ckpt, checkpoint_every=2)
    restore()
    assert os.path.exists(ckpt), "a checkpoint must survive the crash"
    resumed = run(record=record, checkpoint_path=ckpt, checkpoint_every=2)
    assert_same(resumed, full, record)
    assert not os.path.exists(ckpt), "a completed run must remove its checkpoint"


def test_resume_false_starts_cold(tmp_path, monkeypatch, capsys):
    run = ckpt_problem("tuned", n_steps=4)
    ckpt = str(tmp_path / "fleet.npz")
    restore = crash_at(monkeypatch, 4)
    with pytest.raises(RuntimeError):
        run(checkpoint_path=ckpt, checkpoint_every=1)
    restore()
    assert os.path.exists(ckpt)
    # resume=False ignores (and at the end removes) the stale file
    out = run(checkpoint_path=ckpt, checkpoint_every=1, resume=False, progress_every=2)
    assert_same(out, run(), record=False)
    assert not os.path.exists(ckpt)
    err = capsys.readouterr().err
    assert "[fleet] step 2/4 B=4" in err and "done_frac=" in err


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def dict_keys_assigned(path: Path, name: str) -> list:
    """The key sets of the dict literals assigned to `name` in a JAX
    package source file, in source order."""
    tree = ast.parse(path.read_text())
    return [{k.value for k in node.value.keys}
            for node in ast.walk(tree)
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
            and any(isinstance(t, ast.Name) and t.id == name for t in node.targets)]


@pytest.fixture(scope="module")
def jax_cli_keys():
    batch, single = dict_keys_assigned(JAX_PACKAGE / "__main__.py", "out")
    (hostloop,) = dict_keys_assigned(JAX_PACKAGE / "benchfleet.py", "metrics")
    return {"batch": batch, "single": single, "hostloop": hostloop | {"engine"}}


def cli_json(capsys, argv):
    """main(argv)'s one JSON line, and what it wrote to stderr."""
    assert main(argv) == 0
    captured = capsys.readouterr()
    out = captured.out.strip().splitlines()
    assert len(out) == 1
    return json.loads(out[0]), captured.err


def test_cli_list(capsys):
    assert main(["--list"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split()[0] for line in lines] == list(presets.PRESETS)
    assert len(lines) == 7 and all(len(line.split()) > 3 for line in lines)


def test_cli_usage_errors_and_no_card(monkeypatch, capsys):
    for argv in (["not_state", "--hostloop"], ["no_such_preset", "--cpu"]):
        with pytest.raises(SystemExit) as err:
            main(argv)
        assert err.value.code == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["not_state"]) == 1
    captured = capsys.readouterr()
    assert captured.out == "" and "--cpu" in captured.err


@pytest.mark.parametrize("solver", [None, "lqr"])
def test_cli_single_rollout_matches_jax(capsys, jax_cli_keys, solver):
    argv = ["not_state", "--cpu"] + ([] if solver is None else ["--solver", solver])
    out, _ = cli_json(capsys, argv)
    assert set(out) == jax_cli_keys["single"]
    sc = jpresets.not_state()
    if solver is not None:
        sc = dataclasses.replace(sc, config=dataclasses.replace(sc.config, solver=solver))
    res = m4q.mpc(**sc.mpc_args(), key=jax.random.PRNGKey(1))
    xf = np.asarray(res.xs)[:, int(res.n_valid)]
    fid = float(np.real(np.vdot(np.asarray(sc.target_state), xf)))
    assert out["preset"] == "not_state"
    assert (out["exit_code"], out["n_valid"]) == (int(res.exit_code), int(res.n_valid))
    assert out["mean_sqp_iters"] == round(float(np.mean(np.asarray(res.sqp_iters))), 2)
    assert abs(out["fidelity"] - fid) <= 1e-5
    assert out["fidelity"] > (0.95 if solver else 0.999)


def test_cli_batch_mode(capsys, jax_cli_keys):
    out, _ = cli_json(capsys, ["not_state", "--cpu", "--batch", "4", "--seed", "3"])
    assert set(out) == jax_cli_keys["batch"]
    assert out["batch"] == 4 and out["completed_frac"] == 1.0
    assert 0.998 < out["fidelity_min"] <= out["fidelity_mean"] < 1.0


def test_cli_hostloop_with_checkpoint(tmp_path, capsys, jax_cli_keys):
    ckpt = str(tmp_path / "fleet.npz")
    out, err = cli_json(capsys, ["not_state", "--cpu", "--batch", "8", "--hostloop",
                                 "--checkpoint", ckpt, "--checkpoint-every", "5",
                                 "--progress-every", "5"])
    assert jax_cli_keys["hostloop"] <= set(out)
    assert out["engine"] == "hostloop" and out["completed_frac"] == 1.0
    assert out["fidelity_min"] > 0.998 and out["qp_impl"] == "plain"
    assert len(out["checkpoint_s"]) == 3                       # after steps 5, 10, 15
    assert not os.path.exists(ckpt)
    assert "[fleet] step 15/20 B=8" in err
    with pytest.raises(ValueError, match="solver='lqr'"):
        main(["not_state", "--cpu", "--batch", "4", "--hostloop", "--solver", "lqr"])
