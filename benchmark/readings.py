#!/usr/bin/env python3
"""The readings that the limits of `correct` are set from (PERF.md): the
numbers of benchmark/check.py for sound runs of the program on many seeds
(the lower readings), and for the control, the plain reference computed in
TF32 put in the program's place, on a few seeds (the upper readings), each
at the cell's own size, in one process.

    python3 benchmark/readings.py --workload not_state.b16384 --seeds 1,2,3 --control 4,5,6

A fleet cell's program reading is one whole run of the cell's fleet; a
rollout cell's is one rollout on each plant of its pool. One JSON line a
reading on stdout. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def program_outputs(cell, seed: int, device: str, size=None):
    from benchmark import drive

    if cell.entry == "fleet":
        s = drive.Fleet(cell.config, size or cell.traffic["lanes"], seed, device)
        return s.eps, [s.run()]
    s = drive.Rollouts(cell.config, size or cell.traffic["pool"], seed, device)
    return s.eps, [s.run() for _ in range(len(s.eps))]


def control_outputs(cell, seed: int, device: str, size=None):
    """The reference in TF32 as the program's outputs."""
    from benchmark import check, drive
    from benchmark.reference import mpc_plain as ref

    n = size or cell.traffic.get("lanes") or cell.traffic["pool"]
    eps = drive.draws(seed, n, cell.config["lane_detune_scale"])
    out, _ = check.reference_outputs(cell.config, cell.entry, eps, ref.Arith("tf32", device))
    if cell.entry == "fleet":
        return eps, [out]
    return eps, [{"lane": k, **{key: out[key][k] for key in ("final_x", "exit_code", "xs", "us")}}
                 for k in range(n)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--size", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import check, spec

    torch.backends.cuda.matmul.allow_tf32 = False
    cell = spec.load_cell(args.workload)
    seeds = lambda s: [int(v) for v in s.split(",") if v]
    for kind, make, ss in (("program", program_outputs, seeds(args.seeds)),
                           ("control", control_outputs, seeds(args.control))):
        for seed in ss:
            t0 = time.perf_counter()
            eps, outs = make(cell, seed, args.device, args.size)
            numbers = check.compare(cell.config, cell.entry, eps, outs, args.device)
            codes = torch.cat([o["exit_code"].reshape(-1).cpu() for o in outs])
            print(json.dumps({"cell": cell.name, "kind": kind, "seed": seed, **numbers,
                              "codes": {int(c): int((codes == c).sum()) for c in codes.unique()},
                              "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
