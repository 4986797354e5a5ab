"""Two fixed-work probes of the card, printed beside each run so that lines
from different cards and calls can be read side by side (a copy of the
program's bench_torch.device_calibration as it stood when the benchmark was
defined). They measure the machine, not the program, and are never a
metric."""

from __future__ import annotations

import statistics
import time

import torch


def device_calibration(reps: int = 3):
    """(chain_ms, dispatch_ms): one CUDA graph of 200 serial tanh(x @ w), x
    (4096, 32), w = 0.5 I, float32 with TF32 off, replayed; and 32 separate
    launches of t + 1 on an (8,) tensor, then one synchronize, over 32.
    Medians of `reps` after a warm-up, on the host clock."""
    dev = torch.device("cuda")
    x = torch.ones((4096, 32), dtype=torch.float32, device=dev)
    w = 0.5 * torch.eye(32, dtype=torch.float32, device=dev)
    t = torch.ones(8, dtype=torch.float32, device=dev)

    def chain():
        y = x
        for _ in range(200):
            y = torch.tanh(y @ w)
        return y

    torch.backends.cuda.matmul.allow_tf32 = False
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        chain()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        chain()
    graph.replay()
    t = t + 1.0
    torch.cuda.synchronize(dev)
    chain_ms, disp_ms = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        graph.replay()
        torch.cuda.synchronize(dev)
        chain_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        for _ in range(32):
            t = t + 1.0
        torch.cuda.synchronize(dev)
        disp_ms.append((time.perf_counter() - t0) * 1e3 / 32)
    return statistics.median(chain_ms), statistics.median(disp_ms)
