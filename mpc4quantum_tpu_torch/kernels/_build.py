"""Build and load the hand-written CUDA kernels (csrc/*.cu).

On first CUDA use the sources are compiled with nvcc for sm_90a into one
shared library with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/mpc4q_torch_kernels-<hash>.so csrc/*.cu

The library's name carries a hash of the sources and flags, so an edited
source is rebuilt. It is written to `build/` at the repository root. A
missing nvcc or a failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG.parent / "build"
_CUDA_NVCC = "/usr/local/cuda/bin/nvcc"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # P, q, lb, ub, x0, y0, rho0, z, y, aux, B, n, iters, rounds,
    # rho_scale, sigma, alpha, eps_abs, eps_rel, acc_abs, acc_rel, stream
    "mpc4q_boxqp_small": [_P] * 10 + [_I] * 4 + [_F] * 7 + [_P],
    # ar, ai, out_r, out_i, B, d, taylor_k, max_squarings, stream
    "mpc4q_expm_small": [_P] * 4 + [_I] * 4 + [_P],
}

_lib = None
build_seconds = None  # wall time of the nvcc run of this process, if any
ptxas_log = ""        # its -Xptxas -v report: registers, shared memory, spills


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or _CUDA_NVCC
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib, build_seconds, ptxas_log
    if _lib is not None:
        return _lib
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for path in sorted(_CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    out = _BUILD / f"mpc4q_torch_kernels-{digest.hexdigest()[:16]}.so"
    if not out.exists():
        nvcc = _nvcc()
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *_FLAGS, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        build_seconds = time.perf_counter() - t0
        ptxas_log = proc.stderr
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaError_t from a kernel's C entry point."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
