#!/usr/bin/env python3
"""One run of one cell of the benchmark of mpc4quantum_tpu_torch, the
PyTorch and CUDA package, on the CUDA cards of this machine.

    python3 benchmark/run.py --workload not_state.b16384 --seed 7 --seconds 30 --trace 0

Set-up (imports, the CUDA context, the kernel library, which nvcc builds
into build/ on a checkout's first run, the scenario, the lanes drawn from
the seed, the runner, and one whole run of the cell's own shapes) is
`setup_s`. Then, with --trace 0, whole runs of the cell's entry back to back
for --seconds and the end-to-end metrics; with --trace 1, the cell's
traced runs under torch.profiler and its per-layer metrics. Either way
the outputs of every run in the window are held against the plain
reference (benchmark/check.py), and the last line of stdout is one JSON
object: correct, attempted, failed, metrics, device, breakdown (--trace 1)
and checks, each compared number beside its limit, which stderr's last
lines repeat.

Exits 3 without a result when no CUDA card (or fewer than the cell asks
for) is present, and 4 when the JAX package, jax, jaxlib or flax is loaded
once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mpc4quantum_tpu")
NAME_CHARS = 160


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def fixed_caches(root: Path) -> None:
    """Every kernel cache of the run at a fixed path inside the checkout;
    the program's own nvcc build directory is root/build."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton-cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch-extensions")


def power_limit() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def passes(prob, out: dict, gate: float):
    """(lanes, lanes that completed above the fidelity gate) of one output."""
    import torch

    from benchmark.reference.mpc_plain import fidelity

    fx = out["final_x"].reshape(-1, out["final_x"].shape[-1])
    code = out["exit_code"].reshape(-1).cpu()
    ok = ((code == 0) | (code == 1)) & (fidelity(prob, fx).cpu() >= gate)
    return int(code.numel()), int(torch.count_nonzero(ok))


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda", t0: float = T0,
        size: int | None = None) -> dict:
    """One run of `cell` on `device`; `size` replaces the traffic's lanes
    (or pool) for a small run on the CPU. :return: the result object."""
    import numpy as np
    import torch

    from benchmark import check, devtrace, drive, spec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    cfg, tr = cell.config, cell.traffic
    marks = [("imports and CUDA context", time.perf_counter() - t0)]
    if cell.entry == "fleet":
        session = drive.Fleet(cfg, size or tr["lanes"], seed, device)
    elif cell.entry == "rollout":
        session = drive.Rollouts(cfg, size or tr["pool"], seed, device)
    else:
        raise ValueError(f"benchmark: unknown entry {cell.entry!r}")
    marks.append(("scenario, lanes and runner", time.perf_counter() - t0))
    session.run()  # the cell's own shapes, once, before the window
    if hasattr(session, "rescue_batches"):
        session.rescue_batches.clear()
    setup_s = time.perf_counter() - t0
    print("benchmark: set-up, seconds from the start: " + ", ".join(f"{k} {v:.3f}" for k, v in marks)
          + f", one warm run (the kernel library with it) {setup_s:.3f}", file=sys.stderr)

    metrics, breakdown, dev = {}, None, {}
    if trace:
        n = tr["traced_runs"]
        outs: list = []
        out_dir = ROOT / "benchmark" / "out" / cell.name
        events, window_s = devtrace.profile(
            lambda: outs.extend(session.run() for _ in range(n)), out_dir / "trace.json")
        outs = outs[-n:]
        schedule = {}
        if cell.entry == "fleet":
            from benchmark import work

            # a rescue pass runs the same budgets on its padded batch
            batches = [size or tr["lanes"]] * n + [b for b in session.rescue_batches[-n:] if b]
            schedule = work.qp_schedule(cfg, batches)
        summary = devtrace.reduce(
            events, window_s, spec.kernel_map(), entry=cell.entry,
            steps=n * session.n_steps, rollouts=n, schedule=schedule)
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            else:
                print(f"benchmark: {m['name']}: nothing to read", file=sys.stderr)
        breakdown = {"device_ops": [[k[:NAME_CHARS], v] for k, v in summary.device_ops],
                     "idle_gaps": [[k[:NAME_CHARS], v] for k, v in summary.idle_gaps]}
        dev = {"busy_s": summary.busy_s, "window_s": summary.window_s}
        (out_dir / "summary.json").write_text(json.dumps(
            {"seed": seed, **vars(summary),
             "fn_device_s": {str(k): v for k, v in summary.fn_device_s.items()}}, indent=1))
    else:
        outs, wall, each = drive.timed_window(session, seconds, seed)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    prob = spec.reference_problem(cfg)
    gate = cfg["gates"]["fidelity_min"]
    counts = [passes(prob, o, gate) for o in outs]
    attempted = sum(c[0] for c in counts)
    passed = sum(c[1] for c in counts)
    if not trace:
        if cell.entry == "fleet":
            value = passed / wall
            print(f"benchmark: {len(outs)} fleet runs of {counts[0][0]} lanes in {wall:.6f} s "
                  f"(each {min(each):.6f}-{max(each):.6f} s)", file=sys.stderr)
        else:
            ms = [t * 1e3 for t in each]
            value = float(np.percentile(ms, 90))
            print(f"benchmark: {len(ms)} rollouts, median {statistics.median(ms):.4f} ms, "
                  f"p90 {value:.4f} ms", file=sys.stderr)
        for m in cell.end_to_end:
            v = setup_s if m["name"] == "setup_s" else value
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    eps = session.eps
    del session
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = check.compare(cfg, cell.entry, eps, outs, device)
    correct, rows = check.verdict(numbers, cfg["limits"][cell.entry])
    result = {"correct": bool(correct), "attempted": attempted, "failed": attempted - passed,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                         "count": 1, "memory_peak_bytes": int(memory_peak), **dev}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    fixed_caches(ROOT)
    from benchmark import spec

    cell = spec.load_cell(args.workload)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = next(w["chips"] for w in bench["workloads"] if w["name"] == cell.name)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {cell.name} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present",
              file=sys.stderr)
        return 3
    # one process, one host thread: the program's host loop is serial
    torch.set_num_threads(1)
    result = run(cell, args.seed, args.seconds, bool(args.trace))
    from benchmark.calib import device_calibration

    print(f"benchmark: card {power_limit()}; calibration (chain_ms, dispatch_ms) "
          f"{device_calibration()}", flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"check correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
