#!/usr/bin/env python3
"""expm_small at d 33-116, its cluster instance (a row panel a CTA, P copied
to every CTA) against its cluster2d instance (2D tiles of 32, 2 x 2 to
4 x 4 CTAs a matrix) run at the same sizes, on one CUDA card: whether
the 2D tiles should take the cluster instance's range too.

    python3 perf_expm_wide.py

The library routes d 33-116 to the cluster instance; this script also
builds a probe library from csrc/expm_small.cu (nvcc, sm_90a, into build/)
with one more entry point that launches the cluster2d instance's tiles of
32 at any d. For each (d, B) at the budget (12, 2) on -i H of 1-norms
0.05-2: both instances' device time (CUDA graph of 20 calls, CUDA events),
their largest error against the plain version (kernels/expm.expm_small_ref)
and torch.linalg.matrix_exp's time (CUDA events around its calls). One JSON
line a shape, then the card's name and power limit. Without a CUDA device
it exits 1.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
BUILD = ROOT / "build"
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SIZES = (33, 48, 64, 80, 97, 100, 116)
BATCHES = (4, 16, 128)
BUDGET = (12, 2)

SOURCE = r"""
#include "%(src)s"

extern "C" int probe_cluster2d(const void* A, void* out, int B, int d, int taylor_k,
                               int max_squarings, void* stream) {
  return launch_cluster2d<2>(static_cast<const float2*>(A), static_cast<float2*>(out), B, d,
                             taylor_k, max_squarings, static_cast<cudaStream_t>(stream));
}
"""


def build() -> ctypes.CDLL:
    BUILD.mkdir(exist_ok=True)
    src = BUILD / "perf_expm_wide_probe.cu"
    src.write_text(SOURCE % {"src": ROOT / "mpc4quantum_tpu_torch" / "csrc" / "expm_small.cu"})
    lib = BUILD / "perf_expm_wide_probe.so"
    proc = subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                           "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared", "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    dll.probe_cluster2d.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    dll.probe_cluster2d.restype = ctypes.c_int
    return dll


def main() -> int:
    if not torch.cuda.is_available():
        print("perf_expm_wide: no CUDA device; this runs only on a GPU", file=sys.stderr)
        return 1
    from mpc4quantum_tpu_torch.kernels import expm as expm_mod

    dll = build()
    k, sq = BUDGET
    for d in SIZES:
        for B in BATCHES:
            A = cs.expm_batch(B, d, seed=k + d, max_norm=2.0, min_norm=0.05)
            out = torch.empty_like(A)

            def wide():
                rc = dll.probe_cluster2d(A.data_ptr(), out.data_ptr(), B, d, k, sq,
                                         torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"cluster2d at d {d}: CUDA error {rc}")

            lib = lambda: expm_mod.expm_small(A, taylor_k=k, max_squarings=sq)
            ref = expm_mod.expm_small_ref(A, taylor_k=k, max_squarings=sq)
            wide()
            got = lib()
            torch.cuda.synchronize()
            rec = {"d": d, "B": B, "budget": BUDGET,
                   "plan": expm_mod.expm_small_plan(B, d)._asdict(),
                   "cluster_err": float((got - ref).abs().max()),
                   "cluster2d_err": float((out - ref).abs().max()),
                   "cluster_us": cs.graph_us(lib), "cluster2d_us": cs.graph_us(wide),
                   "matrix_exp_ms": cs.cuda_ms(lambda: torch.linalg.matrix_exp(A))}
            print(json.dumps(rec), flush=True)
            cs.require(max(rec["cluster_err"], rec["cluster2d_err"]) <= cs.EXPM_TOL[BUDGET],
                       f"perf_expm_wide: {rec}")
    print(cs.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
