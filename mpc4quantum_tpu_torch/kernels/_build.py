"""Build and load the hand-written CUDA kernels (csrc/*.cu).

On first CUDA use each source is compiled with nvcc for sm_90a, one nvcc
per source and all started together, and the objects are linked into one
shared library with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c -o build/<source>-<hash>.o csrc/<source>.cu
    nvcc -shared -o build/mpc4q_torch_kernels-<hash>.so build/*-<hash>.o

The library's name carries a hash of the sources and flags, so an edited
source is rebuilt. It is written to `build/` at the repository root, with
ptxas's report (registers, spills) beside it. A missing nvcc or a failed
build raises; there is no fallback.
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
          "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # P, q, lb, ub, x0, y0, rho0, z, y, aux, B, n, iters, rounds, scaled,
    # rho_scale, sigma, alpha, eps_abs, eps_rel, acc_abs, acc_rel, stream
    "mpc4q_boxqp_small": [_P] * 10 + [_I] * 5 + [_F] * 7 + [_P],
    # A, out, ws, B, d, taylor_k, max_squarings, stream
    "mpc4q_expm_small": [_P] * 3 + [_I] * 4 + [_P],
    # kinv, q, lb, ub, rho, x, z, y, x_out, z_out, y_out, ws, B, n, iters,
    # sigma, alpha, stream
    "mpc4q_admm_big": [_P] * 12 + [_I] * 3 + [_F] * 2 + [_P],
    # B, size, query, out (5 ints): the launch plan of a call
    "mpc4q_expm_small_plan": [_I] * 3 + [_P],
    "mpc4q_admm_big_plan": [_I] * 3 + [_P],
}

_lib = None
build_seconds = None  # wall time of the nvcc runs of this process, if any
ptxas_log = ""        # the library's -Xptxas -v report: registers, shared memory, spills


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or _CUDA_NVCC
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _compile(nvcc: str, sources: list[Path], tag: str) -> tuple[list[Path], str]:
    """One nvcc per source, all running at once. :return: (objects, the
    concatenated compiler reports)."""
    objs = [_BUILD / f"{src.stem}-{tag}.o" for src in sources]
    logs = [_BUILD / f"{src.stem}-{tag}.log" for src in sources]
    procs = []
    for src, obj, log in zip(sources, objs, logs):
        with open(log, "w") as err:
            procs.append(subprocess.Popen([nvcc, *_FLAGS, "-c", "-o", str(obj), str(src)],
                                          stdout=subprocess.DEVNULL, stderr=err))
    codes = [proc.wait() for proc in procs]
    reports = [log.read_text() for log in logs]
    for log in logs:
        log.unlink()
    failed = [f"{src.name} ({rc}):\n{rep}"
              for src, rc, rep in zip(sources, codes, reports) if rc != 0]
    if failed:
        for obj in objs:
            obj.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return objs, "".join(reports)


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
    tag = digest.hexdigest()[:16]
    out = _BUILD / f"mpc4q_torch_kernels-{tag}.so"
    report_path = out.with_suffix(".ptxas.log")
    if not out.exists():
        nvcc = _nvcc()
        _BUILD.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        objs, report = _compile(nvcc, sources, f"{tag}.{os.getpid()}")
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        for obj in objs:
            obj.unlink()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        build_seconds = time.perf_counter() - t0
        report_path.write_text(report)
        os.replace(tmp, out)
    ptxas_log = report_path.read_text() if report_path.exists() else ""
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def plan(name: str, B: int, size: int, query: bool = False) -> tuple[int, ...]:
    """The kernel library's launch plan of a call (`name` "expm_small" or
    "admm_big" at batch B and size d or n): (instance id, cluster size,
    threads a block, dynamic shared bytes a block, and with `query` the
    clusters of that shape the card holds at once, else 0)."""
    out = (ctypes.c_int * 5)()
    check(getattr(library(), f"mpc4q_{name}_plan")(B, size, int(query), out), f"{name}_plan")
    return tuple(out)


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaError_t from a kernel's C entry point."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
