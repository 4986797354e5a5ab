"""Timing, tracing and throughput counters (counterpart of
mpc4quantum_tpu/utils/profiling.py), and the count of the host's reads of
device flags that a data-dependent exit makes (`host_flag`).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class Timing:
    name: str
    compile_s: float         # the first call: kernel build and warm-up
    best_s: float
    times: list = field(default_factory=list)

    def per_second(self, items: int) -> float:
        return items / self.best_s


def _wait() -> None:
    """Wait for the card's queued work, where the process has used one."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn, *args, reps: int = 3, name: str = "fn") -> Timing:
    """Host-clock time of fn(*args) that ends in a synchronize on the card.
    The first call (kernel build, warm-up) is reported apart as compile_s;
    best_s is the fastest of `reps` later calls."""
    t0 = time.perf_counter()
    fn(*args)
    _wait()
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        _wait()
        times.append(time.perf_counter() - t0)
    return Timing(name=name, compile_s=compile_s, best_s=min(times), times=times)


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """torch.profiler over the block (CPU, and CUDA where there is a card),
    its Chrome trace written to logdir/trace.json; no-op when logdir is
    None. Yields the profiler (None when off) for key_averages()."""
    if logdir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        _wait()
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def mpc_throughput(result, elapsed_s: float) -> dict:
    """Solves/s counters of an MPCResult (one rollout or a lane batch):
    qp_solves counts every SQP iteration (one condensed QP solve each),
    rollouts the rollouts."""
    iters = result.sqp_iters
    iters = iters.detach().cpu().numpy() if torch.is_tensor(iters) else np.asarray(iters)
    n_roll = int(np.prod(iters.shape[:-1])) if iters.ndim > 1 else 1
    return {"rollouts_per_s": n_roll / elapsed_s,
            "qp_solves_per_s": float(iters.sum()) / elapsed_s,
            "mean_sqp_iters": float(iters.mean())}


def host_flag(flag: torch.Tensor) -> bool:
    """bool(flag) of a one-element flag: on the card the host waits for the
    queued work and copies the flag back. Each call adds one to
    host_flag.reads, the count of such reads."""
    host_flag.reads += 1
    return bool(flag)


host_flag.reads = 0
