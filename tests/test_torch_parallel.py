"""The port's multi-device layer against the JAX package on the CPU: the
scenario-sharded fleet (`sharded_mpc`, `sharded_fleet_summary`,
`scaling_report`) and the row-sharded operator (`row_sharded_predict`,
`row_sharded_rollout`, `dp_tp_rollout`, the closed loop through
`tp_model_fns`), each run as 2, 4 or 8 gloo processes.

The JAX references come from the JAX package's own test data, computed in
this process on conftest.py's 8 virtual CPU devices in x64:
tests/test_parallel.py `small_problem` (8 JAX-drawn detuned plants) through
JAX `sharded_mpc`; tests/test_tensor_parallel.py `make_problem(dim_x=64)`
through JAX's row-sharded rollouts on its op mesh, and `make_3q_scenario`
(dim_x 64) through JAX's dense `mpc()` and its 4-lane vmap fleet. They
reach the workers as an npz; each worker joins a gloo group through a
`file://` store in the test's tmp_path (no fixed port), pins torch to one
thread, runs the port in float64 and writes its outputs, which are compared
here. A worker that does not finish within its timeout fails the test.

Tolerances: the sharded fleet equals JAX `sharded_mpc` to 1e-8 on states,
controls and objectives (the single-process `batched_mpc` parity of
tests/test_torch_solvers.py; measured 2.6e-10, 5.1e-10 and 8.4e-10), exit
codes, n_valid and SQP iterations equal, and every rank's result is the
same; the summary's all_reduce equals the port's fleet_summary of the
gathered result to 1e-12 (measured 1.1e-16) and JAX's to 1e-8 on the
fidelities, as the fleet (measured 5.2e-11), and to 1e-6 relative on the
float32 means (the completed fraction and the mean SQP iterations, a mean
of shard means against one mean: 1.2e-7 apart); the open-loop rollouts
1e-10 (JAX's own bound; measured 1e-16); the 3-qubit closed loop and the
DP x TP fleet through the row-sharded seam equal the port's dense loop to
1e-9 (the bound JAX holds its TP loop to; measured 0) and JAX's dense loop
to 2e-8 on controls and 5e-9 on states: one QP of the problem agrees with
JAX's to 1.7e-14, and each of step 1's 9 line-searched SQP iterations (QPs
stopped at eps 1e-6) multiplies the gap by about ten, to 7.6e-9 on the
controls and 1.1e-9 on the states (measured; 7.5e-9 and 1.0e-9 on the
fleet), while JAX's own TP loop equals its dense loop exactly.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import mpc4quantum_tpu as m4q
from mpc4quantum_tpu.parallel.fleet import (make_scenario_batch, scenario_mesh, sharded_mpc,
                                            sharded_fleet_summary)
from mpc4quantum_tpu.parallel.tensor import (dp_tp_rollout, op_mesh, row_sharded_predict,
                                             row_sharded_rollout)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_parallel import small_problem  # noqa: E402
from test_tensor_parallel import make_3q_scenario, make_problem  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FLEET_TOL = 1e-8
SUMMARY_TOL = 1e-12
F32_RTOL = 1e-6
ROLLOUT_TOL = 1e-10
TP_SELF_TOL = 1e-9
TP_JAX_US, TP_JAX_XS = 2e-8, 5e-9
TIMEOUT = 300
DETUNES = 1.0 + 0.01 * np.asarray([-1.0, -0.3, 0.4, 1.2])

_WORKER = textwrap.dedent("""
    import json, os, sys
    rank, world, tmp, case, root = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                    sys.argv[4], sys.argv[5])
    sys.path.insert(0, root)
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import mpc4quantum_tpu_torch as port
    from mpc4quantum_tpu_torch.convert import operator_rows, plant_from_numpy
    from mpc4quantum_tpu_torch.models.dmdc import dmdc_from_operator
    from mpc4quantum_tpu_torch.ops.bilinear import BilinearModel
    from mpc4quantum_tpu_torch.parallel import tensor as tp

    port.init_distributed(f"file://{tmp}/store_{case}", world, rank, device="cpu")
    d = np.load(os.path.join(tmp, "inputs.npz"))
    T = lambda k: torch.tensor(d[k])
    out = {}

    def result(prefix, res):
        for f in ("xs", "us", "exit_code", "n_valid", "objs", "sqp_iters"):
            out[prefix + f] = getattr(res, f).numpy()

    def problem(prefix):
        cfg = json.loads(str(d[prefix + "config"]))
        model = dmdc_from_operator(T(prefix + "A"), cfg.pop("dim_y"), cfg["dim_x"],
                                   cfg.pop("dim_uA"))
        cfg.pop("dim_x")
        sat = cfg.pop("sat")
        return (T(prefix + "x0"), model, T(prefix + "X_targ"), T(prefix + "U_targ"),
                T(prefix + "Q"), T(prefix + "R"), T(prefix + "Qf"), port.MPCConfig(**cfg), sat)

    if case == "fleet":
        x0, model, Xt, Ut, Q, R, Qf, cfg, sat = problem("s_")
        plants = plant_from_numpy({"H0": d["s_H0"], "H1s": d["s_H1s"], "sigma": d["s_sigma"]})
        mesh = port.scenario_mesh()
        res = port.sharded_mpc(mesh, x0, model, plants, Xt, Ut, Q, R, Qf, cfg, sat)
        result("", res)
        summ = port.sharded_fleet_summary(mesh, res, T("s_target"))
        out["summary"] = np.array(json.dumps({k: float(v) for k, v in summ.items()}))
        summ = port.fleet_summary(res, T("s_target"))
        out["summary_gathered"] = np.array(json.dumps({k: float(v) for k, v in summ.items()}))
        run = lambda m, b: port.sharded_mpc(m, x0, model, plants[:b], Xt, Ut, Q, R, Qf, cfg, sat)
        rows = port.scaling_report(run, batch_per_device=2, device_counts=(1, world), reps=1)
        out["rows"] = np.array(json.dumps(rows))
        try:
            port.sharded_mpc(mesh, x0, model, plants[:2 * world - 1], Xt, Ut, Q, R, Qf, cfg, sat)
            out["indivisible"] = np.array("no error")
        except ValueError as e:
            out["indivisible"] = np.array(str(e))
    elif case == "tp":
        mesh = tp.op_mesh(n_op=world)
        A, x0, ux = T("r_A"), T("r_x0"), T("r_ux")
        blk = operator_rows(d["r_A"], rank, world, device="cpu")
        out["predict_whole"] = tp.row_sharded_predict(mesh, A, x0, ux).numpy()
        out["predict_block"] = tp.row_sharded_predict(mesh, blk, x0, ux).numpy()
        bm = BilinearModel.from_stacked(A[:, :64], A[:, 64:], 2, 1)
        out["rollout"] = tp.row_sharded_rollout(mesh, blk, bm.lift_u, x0, T("r_us")).numpy()
        try:
            tp.row_sharded_predict(mesh, A[:6, :18], x0[:6], ux[:12])
            out["indivisible"] = np.array("no error")
        except ValueError as e:
            out["indivisible"] = np.array(str(e))
        x0, model, Xt, Ut, Q, R, Qf, cfg, sat = problem("q_")
        plant = plant_from_numpy({"H0": d["q_H0"], "H1s": d["q_H1s"], "sigma": d["q_sigma"]})
        args = (x0, model, plant, Xt, Ut, Q, R, Qf, cfg, sat)
        fns = tp.tp_model_fns(mesh, dim_u=3, order=1, dim_x=64)
        result("tp_", port.mpc(*args, model_fns=fns))
        result("dense_", port.mpc(*args))
    elif case == "dptp":
        mesh = tp.op_mesh(n_scenario=2, n_op=4)
        A = T("r_A")
        bm = BilinearModel.from_stacked(A[:, :64], A[:, 64:], 2, 1)
        out["dp_tp"] = tp.dp_tp_rollout(mesh, A, bm.lift_u, T("r_x0"), T("r_us_batch")).numpy()
        x0, model, Xt, Ut, Q, R, Qf, cfg, sat = problem("q_")
        plants = plant_from_numpy({"H0": d["q_H0s"], "H1s": d["q_H1ss"], "sigma": d["q_sigmas"]})
        args = (x0, model, plants, Xt, Ut, Q, R, Qf, cfg, sat)
        fns = tp.tp_model_fns(mesh, dim_u=3, order=1, dim_x=64)
        result("tp_", port.sharded_mpc(mesh, *args, model_fns=fns))
        result("dense_", port.batched_mpc(*args))
    np.savez(os.path.join(tmp, f"out_{case}_{rank}.npz"), **out)
    torch.distributed.destroy_process_group()
""")


def problem_arrays(prefix, args, target=None):
    """A JAX problem's arrays and config for the workers (sat and the model
    dims ride in the config's JSON)."""
    cfg = args["config"]
    A = np.asarray(args["model_state"].A)
    conf = dict(horizon=cfg.horizon, n_steps=cfg.n_steps, dt=cfg.dt, dim_u=cfg.dim_u,
                order=cfg.order, max_iter=cfg.max_iter, sat=float(args["sat"]),
                dim_y=A.shape[0], dim_x=A.shape[0], dim_uA=A.shape[1] - A.shape[0])
    out = {prefix + k: np.asarray(args[k]) for k in ("x0", "X_targ", "U_targ", "Q", "R", "Qf")}
    out[prefix + "A"] = A
    out[prefix + "config"] = np.array(json.dumps(conf))
    if target is not None:
        out[prefix + "target"] = np.asarray(target)
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX results and the workers' inputs (inputs.npz in a shared dir)."""
    ref, inputs = {}, {}
    # the sharded fleet: test_parallel's small problem on 8 JAX-drawn plants
    rho0, model, base_plant, X_targ, U_targ, Q, R, Qf, config, sat, targ = small_problem()
    plants, keys = make_scenario_batch(jax.random.PRNGKey(1), base_plant, 8, detune_scale=0.02)
    mesh = scenario_mesh()
    res = sharded_mpc(mesh, jnp.asarray(rho0), model, plants, X_targ, U_targ, Q, R, Qf,
                      config, sat, keys=keys)
    ref["fleet"] = res
    ref["summary"] = sharded_fleet_summary(mesh, res, jnp.asarray(targ))
    inputs.update(problem_arrays("s_", dict(x0=rho0, model_state=model, X_targ=X_targ,
                                            U_targ=U_targ, Q=Q, R=R, Qf=Qf, config=config,
                                            sat=sat), targ))
    inputs.update(s_H0=np.asarray(plants.H0), s_H1s=np.asarray(plants.H1s),
                  s_sigma=np.asarray(plants.sigma))
    # the open-loop rollouts on make_problem(dim_x=64)
    A, bm, x0 = make_problem()
    rng = np.random.default_rng(1)
    u = rng.normal(size=(2,))
    fu = bm.lift_u(jnp.asarray(u).reshape(-1, 1))[:, 0]
    ux = jnp.kron(fu.astype(x0.dtype), x0)
    us = rng.normal(size=(2, 7)) * 0.3
    us_batch = rng.normal(size=(8, 2, 5)) * 0.3
    ref["predict"] = row_sharded_predict(op_mesh(n_op=4), A, x0, ux)
    ref["rollout"] = row_sharded_rollout(op_mesh(n_op=4), A, bm.lift_u, x0, jnp.asarray(us))
    ref["dp_tp"] = dp_tp_rollout(op_mesh(n_scenario=2, n_op=4), A, bm.lift_u, x0,
                                 jnp.asarray(us_batch))
    inputs.update(r_A=np.asarray(A), r_x0=np.asarray(x0), r_ux=np.asarray(ux), r_us=us,
                  r_us_batch=us_batch)
    # the 3-qubit closed loop and its 4-lane fleet, dense
    args, _ = make_3q_scenario()
    ref["3q"] = m4q.mpc(**args, key=jax.random.PRNGKey(3))
    plants = jax.vmap(lambda dd: args["plant"].replace(
        H0=args["plant"].H0 * dd.astype(args["plant"].H0.dtype)))(jnp.asarray(DETUNES))
    base = {k: v for k, v in args.items() if k != "plant"}
    keys = jax.random.split(jax.random.PRNGKey(7), 4)
    ref["3q_fleet"] = jax.vmap(lambda p, k: m4q.mpc(**base, plant=p, key=k))(plants, keys)
    inputs.update(problem_arrays("q_", args))
    inputs.update(q_H0=np.asarray(args["plant"].H0), q_H1s=np.asarray(args["plant"].H1s),
                  q_sigma=np.asarray(args["plant"].sigma), q_H0s=np.asarray(plants.H0),
                  q_H1ss=np.asarray(plants.H1s), q_sigmas=np.asarray(plants.sigma))
    tmp = tmp_path_factory.mktemp("dist")
    np.savez(tmp / "inputs.npz", **inputs)
    return ref, tmp


def spawn(tmp: Path, case: str, world: int) -> list:
    """Run the case's worker as `world` gloo processes; each one's outputs."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(world), str(tmp),
                               case, str(ROOT)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"{case}: a worker did not finish in {TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{case} rank {r} failed ({p.returncode}):\n{log[-3000:]}"
    return [dict(np.load(tmp / f"out_{case}_{r}.npz")) for r in range(world)]


def close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=tol)


def check_result(out, res, prefix="", tol=FLEET_TOL, us_tol=None, xs_tol=None):
    close(out[prefix + "us"], res.us, tol if us_tol is None else us_tol)
    close(out[prefix + "xs"], res.xs, tol if xs_tol is None else xs_tol)
    np.testing.assert_array_equal(out[prefix + "exit_code"], np.asarray(res.exit_code))
    np.testing.assert_array_equal(out[prefix + "n_valid"], np.asarray(res.n_valid))
    np.testing.assert_array_equal(out[prefix + "sqp_iters"], np.asarray(res.sqp_iters))


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_fleet_matches_jax(reference, world):
    """sharded_mpc over 2 and 4 gloo ranks returns the global result on
    every rank, equal to JAX sharded_mpc on its 8 devices; the summary's
    all_reduce equals JAX's pmean / pmin; scaling_report's rows; a batch
    the mesh does not divide raises."""
    ref, tmp = reference
    outs = spawn(tmp, "fleet", world)
    res = ref["fleet"]
    for out in outs:
        check_result(out, res)
        close(out["objs"], res.objs, FLEET_TOL)
        summ = json.loads(str(out["summary"]))
        gathered = json.loads(str(out["summary_gathered"]))
        assert set(summ) == set(ref["summary"]) == set(gathered)
        for k, v in ref["summary"].items():
            # the completed fraction and the mean SQP iterations are float32
            # means, in JAX and in the port (their lanes' counts are equal)
            f32 = not k.startswith("fid")
            rtol = F32_RTOL if f32 else 0.0
            np.testing.assert_allclose(summ[k], float(v), rtol=rtol,
                                       atol=0.0 if f32 else FLEET_TOL, err_msg=k)
            np.testing.assert_allclose(summ[k], gathered[k], rtol=rtol,
                                       atol=0.0 if f32 else SUMMARY_TOL, err_msg=k)
        rows = json.loads(str(out["rows"]))
        assert [(r["devices"], r["batch"]) for r in rows] == [(1, 2), (world, 2 * world)]
        for r in rows:
            assert set(r) == {"devices", "batch", "best_s", "per_device_throughput",
                              "efficiency"}
            assert r["best_s"] > 0 and r["per_device_throughput"] > 0
        assert rows[0]["efficiency"] == 1.0
        assert "divisible" in str(out["indivisible"]), out["indivisible"]
    assert json.loads(str(outs[0]["rows"])) == json.loads(str(outs[-1]["rows"]))


def test_row_sharded_operator_on_four_ranks(reference):
    """row_sharded_predict (whole A, or each rank holding only its rows)
    and row_sharded_rollout on a 4-rank op axis against JAX's, dim_x 64;
    a dim_x the axis does not divide raises; the 3-qubit closed loop
    through tp_model_fns against the port's dense loop and JAX's."""
    ref, tmp = reference
    for out in spawn(tmp, "tp", 4):
        close(out["predict_whole"], ref["predict"], ROLLOUT_TOL)
        close(out["predict_block"], ref["predict"], ROLLOUT_TOL)
        close(out["rollout"], ref["rollout"], ROLLOUT_TOL)
        assert "divisible" in str(out["indivisible"]), out["indivisible"]
        for f in ("us", "xs", "objs"):
            close(out["tp_" + f], out["dense_" + f], TP_SELF_TOL)
        assert int(out["tp_exit_code"]) == 0
        check_result(out, ref["3q"], "tp_", us_tol=TP_JAX_US, xs_tol=TP_JAX_XS)
        fid = float(np.real(out["tp_xs"][[0, 63], -1] @ [0.0, 1.0]))
        assert fid > 0.5, fid


def test_dp_tp_on_a_two_by_four_mesh(reference):
    """DP x TP on 8 ranks: dp_tp_rollout gives each scenario shard its own
    lanes of JAX's; the 4-lane 3-qubit fleet through sharded_mpc with
    tp_model_fns on the same mesh equals the port's dense fleet and JAX's
    dense vmap fleet."""
    ref, tmp = reference
    outs = spawn(tmp, "dptp", 8)
    for rank, out in enumerate(outs):
        shard = rank // 4
        close(out["dp_tp"], np.asarray(ref["dp_tp"])[4 * shard:4 * shard + 4], ROLLOUT_TOL)
        for f in ("us", "xs", "objs"):
            close(out["tp_" + f], out["dense_" + f], TP_SELF_TOL)
        check_result(out, ref["3q_fleet"], "tp_", us_tol=TP_JAX_US, xs_tol=TP_JAX_XS)


def test_chip_smoke_builds_the_jax_three_qubit_problem():
    """chip_smoke.py's tp_3q phase builds make_3q_scenario in the port:
    the same operator, plant, start, targets and costs (1e-15)."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    args_j, targ_j = make_3q_scenario()
    args_t, targ_t = chip_smoke.three_qubit_problem("cpu", torch.float64)
    for k in ("x0", "X_targ", "U_targ", "Q", "R", "Qf"):
        close(args_t[k], args_j[k], 1e-15)
    close(args_t["model_state"].A, args_j["model_state"].A, 1e-15)
    close(args_t["plant"].H0, args_j["plant"].H0, 1e-15)
    close(args_t["plant"].H1s, args_j["plant"].H1s, 1e-15)
    close(targ_t, targ_j, 0.0)
    cfg_t, cfg_j = args_t["config"], args_j["config"]
    assert (cfg_t.horizon, cfg_t.n_steps, cfg_t.dt, cfg_t.dim_u, cfg_t.order) == \
        (cfg_j.horizon, cfg_j.n_steps, cfg_j.dt, cfg_j.dim_u, cfg_j.order)
    assert args_t["sat"] == args_j["sat"] and args_t["du"] is args_j["du"] is None
