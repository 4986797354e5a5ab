#!/usr/bin/env python3
"""Where each fleet's device time goes, on one CUDA card.

    python3 perf_fleets.py [fleet ...]

Runs each fleet of chip_smoke.FLEETS at its batch (the main pass only, where
a fleet has a rescue pass), then the two learned-model fleets (chip_smoke's
LEARN and DISCREP: per-lane refits, recorded) and the four scenarios of no
preset (chip_smoke's SLICE_FLEETS: damped_pair, cnot_h80, damped_chain4,
cnot_h250), or only the
fleets named: one warm-up run, then one run under torch.profiler. Prints one JSON line a fleet - device time
in all and by kernel, launches, and the busy share against the unprofiled
wall time - then the card's name and power limit. The profiler on the
card's host at times records no device activity; such a run is made again,
up to three times. Without a CUDA device it exits 1.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def profiled(fn) -> list:
    """(name, microseconds) of every device activity - kernel, copy, fill -
    that fn() ran, by torch.profiler; made again, up to three times, while
    the profiler records none."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        acts = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if acts:
            return acts
    raise RuntimeError("perf_fleets: the profiler recorded no device activity in three runs")


def fleets():
    """(name, scenario, plants, run keywords) of every fleet profiled."""
    from mpc4quantum_tpu_torch import presets
    from mpc4quantum_tpu_torch.models import dmdc
    from mpc4quantum_tpu_torch.parallel.fleet import make_scenario_batch

    lanes = lambda sc, B: make_scenario_batch(sc.plant, B, generator=torch.Generator().manual_seed(1))
    for name, spec in cs.FLEETS.items():
        sc = cs.fleet_preset(presets, name)()
        yield name, sc, lanes(sc, spec["batch"]), {}
    for name, kind, spec in (("learn", "online", cs.LEARN), ("discrep", "discrep", cs.DISCREP)):
        sc, fit = cs.learned_scenario(presets, dmdc, kind)
        B, sigma = spec["batch"], spec.get("sigma", 0.0)
        plants = lanes(sc, B)
        plants = dataclasses.replace(plants, sigma=plants.sigma + sigma)
        gen = torch.Generator(device=plants.device).manual_seed(7) if sigma else None
        yield name, sc, plants, dict(record=True, generator=gen, model_update_fn=fit)
    for name, make in (("damped_pair", presets.damped_pair_scenario),
                       ("cnot_h80", presets.cnot_h80_scenario),
                       ("damped_chain4", presets.damped_chain4_scenario),
                       ("cnot_h250", presets.cnot_h250_scenario)):
        sc = make("cuda", torch.float32)
        yield name, sc, lanes(sc, cs.SLICE_FLEETS[name]["batch"]), {}


def profile_fleets(names=()):
    from mpc4quantum_tpu_torch.benchfleet import make_runner, run_hostloop_fleet

    for name, sc, plants, run_kw in fleets():
        if names and name not in names:
            continue
        B = plants.lanes
        metrics, _ = run_hostloop_fleet(sc, B, plants=plants, reps=2, **run_kw)
        runner = make_runner(sc, plants)
        args = (sc.x0, sc.model, plants, sc.X_targ, sc.U_targ, sc.Q, sc.R, sc.Qf)
        acts = profiled(lambda: runner.run(*args, **run_kw))
        device = sum(t for _, t in acts)
        by_kernel = {}
        for key in ("boxqp_small_kernel", "admm_big_kernel", "admm_cluster_kernel",
                    "admm_stream_kernel", "expm_small_kernel", "expm_tile_kernel",
                    "expm_cluster_kernel", "expm_wide_kernel"):
            times = [t for n, t in acts if key in n]
            by_kernel[key] = {"launches": len(times), "device_ms": sum(times) / 1e3,
                              "device_us_a_launch": sum(times) / max(len(times), 1)}
        wall = B / metrics["rollouts_per_s"]
        cs.emit({"measure": "fleet", "preset": name, "batch": B, "wall_s": wall,
                 "rollouts_per_s": metrics["rollouts_per_s"], "device_ms": device / 1e3,
                 "busy": device / 1e6 / wall, "device_activities": len(acts),
                 "kernels": by_kernel})


def main() -> int:
    if not torch.cuda.is_available():
        print("perf_fleets: no CUDA device; this runs only on a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    profile_fleets(sys.argv[1:])
    print(cs.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
