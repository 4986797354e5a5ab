"""The traced run's source: torch.profiler over whole runs of the cell's
entry, reduced to the aggregates the per-layer readers take.

The profiler's Chrome trace (CPU ops, CUDA runtime and driver calls, and
the device's kernels, copies and sets) is written to one fixed file under
benchmark/out/<cell>/ and read back; only the last traced run's file is
kept. When the card's host records no device event (which happens on some
hosts for a process's first trace) the traced runs are made again, up to
three times in all, and the run fails after that.
"""

from __future__ import annotations

import dataclasses
import json
import time
from collections import Counter, defaultdict
from pathlib import Path
from typing import Callable

import torch

from .spec import function_of

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
# runtime and driver calls that put work on the device
LAUNCH_WORDS = ("Launch", "Memcpy", "Memset")
SYNC_WORD = "Synchronize"
ATTEMPTS = 3


@dataclasses.dataclass
class Summary:
    """What a traced window holds, as the per-layer readers see it.

    entry: "fleet" or "rollout"; steps: MPC steps run (a fleet run's steps,
    not its lanes); rollouts: whole rollouts (fleet runs or mpc() calls);
    window_s: the host clock around the traced work; busy_s: the union of
    device activity; runtime_calls: launch, copy and set calls of the CUDA
    runtime and driver; syncs: synchronize calls plus device-to-host copies;
    fn_device_s: device seconds by the function a kernel implements (the
    kernel map), None for activities no hand-written kernel implements;
    fn_launches: launches by function; schedule: {function: (launches,
    flops, bytes)} that the budgets imply, or {} where they fix none."""

    entry: str
    steps: int
    rollouts: int
    window_s: float
    busy_s: float
    runtime_calls: int
    syncs: int
    fn_device_s: dict
    fn_launches: dict
    schedule: dict
    device_ops: list
    idle_gaps: list


def profile(work: Callable[[], None], trace_path: Path):
    """Run `work` (whole runs ending in a synchronize) under the profiler,
    retried while the trace holds no device activity. :return: (events,
    window_s)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    trace_path.parent.mkdir(parents=True, exist_ok=True)
    for attempt in range(ATTEMPTS):
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            work()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        prof.export_chrome_trace(str(trace_path))
        events = json.loads(trace_path.read_text())["traceEvents"]
        if any(e.get("cat") in DEVICE_CATS for e in events):
            return events, window_s
    raise RuntimeError(f"benchmark: {ATTEMPTS} traces held no device activity")


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events: list, window_s: float, kmap: list, *, entry: str, steps: int, rollouts: int,
           schedule: dict, top: int = 10) -> Summary:
    """The aggregates of one traced window's events (Chrome trace, times in us)."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    rt = [e for e in events if e.get("ph") == "X" and e.get("cat") in RUNTIME_CATS]
    busy = _merge((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev)
    fn_s, fn_n, by_name = defaultdict(float), Counter(), defaultdict(float)
    for e in dev:
        fn = function_of(e["name"], kmap) if e["cat"] == "kernel" else None
        fn_s[fn] += float(e["dur"]) * 1e-6
        if fn is not None:
            fn_n[fn] += 1
        by_name[e["name"]] += float(e["dur"]) * 1e-6
    d2h = sum(1 for e in dev if e["cat"] == "gpu_memcpy" and "DtoH" in e["name"])
    return Summary(
        entry=entry, steps=steps, rollouts=rollouts, window_s=window_s,
        busy_s=sum(e - s for s, e in busy) * 1e-6,
        runtime_calls=sum(1 for e in rt if any(w in e["name"] for w in LAUNCH_WORDS)),
        syncs=sum(1 for e in rt if SYNC_WORD in e["name"]) + d2h,
        fn_device_s=dict(fn_s), fn_launches=dict(fn_n), schedule=schedule,
        device_ops=sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:top],
        idle_gaps=_idle_gaps(events, busy, top))


def _idle_gaps(events: list, busy: list, top: int) -> list:
    """The longest gaps between device activity, each named by the
    innermost CPU op on the main thread at the gap's start."""
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    if not ops or len(busy) < 2:
        return []
    main_tid = Counter(e["tid"] for e in ops).most_common(1)[0][0]
    ops = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in ops if e["tid"] == main_tid))
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1]) for i in range(len(busy) - 1)),
                  reverse=True)[:top]
    out = []
    for length, at in gaps:
        label = "host"
        for s, e, name in ops:
            if s > at:
                break
            if e >= at:
                label = name  # later starts nest inside earlier ones
        out.append([label, length * 1e-6])
    return out

