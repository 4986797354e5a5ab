"""The system under test, driven through its own entries: a fleet of lanes
through `benchfleet.make_runner` + `FleetRunner.run` (with the
configuration's rescue pass, `benchfleet.rescue_pass`), or one rollout at a
time through `mpc()`.

The benchmark makes the inputs: each lane's (or each pooled plant's)
detuning eps, one draw of N(0, scale^2) from each of n strata of equal
probability, in an order drawn from the seed (`draws`), and hands the same
draws to the plain reference. Every seed so holds nearly the same set of
detunings, in another order: a jittered robustness grid, whose work does
not move with the seed. The program builds its scenario from its own
preset; nothing it makes reaches the reference.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch


def draws(seed: int, n: int, scale: float) -> np.ndarray:
    """The seed's n detunings, float64, on the CPU whatever the device:
    scale * Phi^-1((k + u_k) / n) for the strata k in an order drawn from
    the seed, u_k ~ U(0, 1)."""
    g = torch.Generator().manual_seed(int(seed))
    u = torch.rand(n, generator=g, dtype=torch.float64).clamp(1e-12, 1 - 1e-12)
    k = torch.randperm(n, generator=g).to(torch.float64)
    return (scale * torch.special.ndtri((k + u) / n)).numpy()


def lane_plants(base, eps: np.ndarray, device, dtype):
    """A lane batch of the program's nominal plant `base` (a float64 CPU
    plant), its drift field scaled by 1 + eps a lane, the rest repeated."""
    n = len(eps)
    scale = torch.as_tensor(1.0 + eps)

    def fields(plant):
        out = {}
        for name, t in plant.tensor_fields().items():
            t = t.expand(n, *t.shape).clone()
            if name == plant.drift:
                t = t * scale.reshape((n,) + (1,) * (t.dim() - 1))
            out[name] = t
        return dataclasses.replace(plant, **out)

    return fields(base).to(device, dtype)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Fleet:
    """One fleet of `lanes` plants; `run()` is one whole fleet run with the
    per-step record, plus the rescue pass where the configuration has one."""

    # a window keeps the records of three runs (`keep`)
    prune = True

    def __init__(self, config: dict, lanes: int, seed: int, device, dtype=torch.float32):
        from mpc4quantum_tpu_torch import presets
        from mpc4quantum_tpu_torch.benchfleet import make_runner

        prog = config["program"]
        make = presets.PRESETS[prog["preset"]]
        self.device = torch.device(device)
        self.sc = make(**prog["kwargs"], device=self.device, dtype=dtype)
        self.eps = draws(seed, lanes, config["lane_detune_scale"])
        base = make(**prog["kwargs"], device="cpu", dtype=torch.float64).plant
        self.plants = lane_plants(base, self.eps, self.device, dtype)
        self.runner = make_runner(self.sc, self.plants)
        self.rescue = None
        if config.get("rescue"):
            kw = {**prog["kwargs"], "order": config["rescue"]["order"]}
            self.rescue = {"threshold": config["rescue"]["threshold"],
                           "scenario": make(**kw, device=self.device, dtype=dtype)}
        self.n_steps = self.sc.config.n_steps
        self.rescue_batches: list = []

    def run(self) -> dict:
        from mpc4quantum_tpu_torch.benchfleet import fleet_fidelity, rescue_pass

        sc = self.sc
        out = self.runner.run(sc.x0, sc.model, self.plants, sc.X_targ, sc.U_targ, sc.Q, sc.R,
                              sc.Qf, record=True)
        if self.rescue is not None:
            info = rescue_pass(sc, self.rescue, self.plants, out,
                               fleet_fidelity(sc, out["final_x"]), "auto")
            self.rescue_batches.append(info.get("rescue_batch", 0))
        _sync(self.device)
        return {k: out[k] for k in ("final_x", "exit_code", "xs", "us")}


class Rollouts:
    """`mpc()` of the configuration's scenario on the kernel route, one
    plant of a pool drawn from the seed per call, in turn."""

    # a rollout's record is small: every one is kept
    prune = False

    def __init__(self, config: dict, pool: int, seed: int, device, dtype=torch.float32):
        from mpc4quantum_tpu_torch import presets

        prog = config["program"]
        make = presets.PRESETS[prog["preset"]]
        self.device = torch.device(device)
        sc = make(**prog["kwargs"], device=self.device, dtype=dtype)
        self.args = {**sc.mpc_args(), "config": dataclasses.replace(sc.config, qp_backend="ns")}
        self.eps = draws(seed, pool, config["lane_detune_scale"])
        base = make(**prog["kwargs"], device="cpu", dtype=torch.float64).plant
        self.pool = lane_plants(base, self.eps, self.device, dtype)
        self.n_steps = sc.config.n_steps
        self.calls = 0

    def run(self) -> dict:
        from mpc4quantum_tpu_torch.mpc.fleet_runner import mpc

        k = self.calls % len(self.eps)
        res = mpc(**{**self.args, "plant": self.pool[k]})
        _sync(self.device)
        self.calls += 1
        return {"lane": k, "final_x": res.xs[:, -1], "exit_code": res.exit_code,
                "xs": res.xs, "us": res.us}


def keep(outs: list, out: dict, rng: np.random.Generator) -> None:
    """Append a run's output to `outs`, keeping the per-step record ("xs",
    "us") only of the first run, the newest, and one of those between drawn
    uniformly by `rng` (reservoir sampling): the outcome of every run is
    judged, the steps of three."""
    outs.append(out)
    n = len(outs)
    if n >= 3 and rng.integers(n - 2) == 0:
        # run n - 2 (0-based) replaces the drawn middle run
        for o in outs[1:-2]:
            if "xs" in o:
                o.pop("xs"), o.pop("us")
    elif n >= 3:
        outs[-2].pop("xs"), outs[-2].pop("us")


def timed_window(session, seconds: float, seed: int):
    """Whole runs back to back until the first that ends at or after
    `seconds`: (outputs, wall seconds, each run's seconds)."""
    outs, each = [], []
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        out = session.run()
        if session.prune:
            keep(outs, out, rng)
        else:
            outs.append(out)
        now = time.perf_counter()
        each.append(now - t)
        if now - t0 >= seconds:
            return outs, now - t0, each
