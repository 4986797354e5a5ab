#!/usr/bin/env python3
"""What one iteration's exchange costs in a thread-block cluster, on one
CUDA card: the question behind admm_big's cluster instance, whose every
iteration sends each CTA's rows of the next rhs vector to every CTA of the
cluster and then waits for the whole vector.

    python3 perf_cluster.py

Builds a probe kernel (nvcc, sm_90a, into build/) and times, per iteration
of a loop of `ITERS`, at admm_big's n = 240 layout (clusters of 2 CTAs of
256 threads, each CTA sending its 120 rows' floats to both CTAs, double-
buffered), on 256 CTAs (B 128, two CTAs an SM) and on one cluster:
- sync: cluster.sync() alone;
- store_sync: the remote stores (generic stores through map_shared_rank)
  and cluster.sync(), the exchange of the first cluster instance;
- block: __syncthreads() alone, no exchange (a lower bound);
- async: each row's float sent by st.async to every CTA, completing bytes
  on that CTA's mbarrier of the buffer; each CTA waits for its whole
  vector (4 n bytes) on its own mbarrier, after a __syncthreads() that
  ends its reads of the other buffer: no cluster-wide barrier.
Each mode's vector is checked at the end. Prints one JSON line and the
card's name and power limit. Without a CUDA device it exits 1.
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
ITERS = 2000
N, C, THREADS = 240, 2, 256
MODES = ("sync", "store_sync", "block", "async")

SOURCE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>
namespace cg = cooperative_groups;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// rows [rank R, rank R + R) of an n-vector; each iteration every CTA sends
// its rows' values (it + row) to every CTA's next buffer; mode 0 barrier
// only, 1 generic remote stores + cluster.sync, 2 __syncthreads only,
// 3 st.async + mbarrier complete_tx
template <int MODE>
__global__ void __launch_bounds__(512, 1) probe(float* out, int n, int iters) {
  extern __shared__ __align__(16) float buf[];  // two n-vectors, then two mbarriers
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int R = (n + c - 1) / c;
  const int t = threadIdx.x;
  uint64_t* bar = reinterpret_cast<uint64_t*>(buf + 2 * n);  // 8 n bytes in: aligned
  for (int e = t; e < 2 * n; e += blockDim.x) buf[e] = 0.0f;
  if (MODE == 3 && t == 0) {
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar + b)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();
  const int row = rank * R + t;
  const bool own = t < R && row < n;
  for (int it = 0; it < iters; ++it) {
    float* nxt = buf + ((it + 1) & 1) * n;
    const float v = (float)(it + row);
    if (MODE == 0) {
      cluster.sync();
    } else if (MODE == 1) {
      if (own)
        for (int dst = 0; dst < c; ++dst) cluster.map_shared_rank(nxt, dst)[row] = v;
      cluster.sync();
    } else if (MODE == 2) {
      if (own) nxt[row] = v;
      __syncthreads();
    } else {
      const int b = (it + 1) & 1;
      // this CTA's whole next vector: 4 n bytes on its barrier b
      if (t == 0)
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     ::"r"(smem_u32(bar + b)), "r"(4 * n) : "memory");
      // every thread's reads of buffer b ended in the last iteration
      __syncthreads();
      if (own) {
        for (int dst = 0; dst < c; ++dst) {
          uint32_t addr, mbar;
          asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(addr) : "r"(smem_u32(nxt + row)), "r"(dst));
          asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(mbar) : "r"(smem_u32(bar + b)), "r"(dst));
          asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
                       ::"r"(addr), "r"(__float_as_uint(v)), "r"(mbar) : "memory");
        }
      }
      // barrier b's phase it / 2 ends when the 4 n bytes arrive
      const uint32_t parity = (it >> 1) & 1;
      uint32_t done = 0;
      while (!done)
        asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
                     : "=r"(done) : "r"(smem_u32(bar + b)), "r"(parity) : "memory");
    }
  }
  if (MODE != 2) cluster.sync();  // no CTA exits while another may store into it
  const float* last = buf + (iters & 1) * n;
  for (int e = t; e < n; e += blockDim.x) out[(size_t)blockIdx.x * n + e] = last[e];
}

template <int MODE>
int launch(float* out, int blocks, int c, int threads, int n, int iters, void* stream) {
  const int smem = 8 * n + 32;
  cudaFuncSetAttribute(probe<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = c;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, probe<MODE>, out, n, iters);
}

extern "C" int probe_launch(int mode, float* out, int blocks, int c, int threads, int n,
                            int iters, void* stream) {
  switch (mode) {
    case 0: return launch<0>(out, blocks, c, threads, n, iters, stream);
    case 1: return launch<1>(out, blocks, c, threads, n, iters, stream);
    case 2: return launch<2>(out, blocks, c, threads, n, iters, stream);
    default: return launch<3>(out, blocks, c, threads, n, iters, stream);
  }
}
"""


def build() -> ctypes.CDLL:
    BUILD.mkdir(exist_ok=True)
    src, lib = BUILD / "perf_cluster.cu", BUILD / "perf_cluster.so"
    src.write_text(SOURCE)
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared", "-o", str(lib),
                    str(src)], check=True)
    dll = ctypes.CDLL(str(lib))
    dll.probe_launch.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    return dll


def time_mode(dll, mode: int, blocks: int) -> dict:
    out = torch.empty((blocks, N), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    run = lambda iters: dll.probe_launch(mode, out.data_ptr(), blocks, C, THREADS, N, iters,
                                         stream)
    assert run(10) == 0
    torch.cuda.synchronize()
    ms = []
    for iters in (ITERS // 2, ITERS):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        assert run(iters) == 0
        stop.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(stop))
    # the last vector: iteration ITERS - 1 sent it + row (mode 0 sends nothing)
    want = torch.arange(N, device="cuda", dtype=torch.float32) + (ITERS - 1)
    ok = mode == 0 or bool((out[:, :N] == want).all()) if mode != 2 else True
    # per iteration: the difference of the two loop lengths, so launch and
    # set-up cancel
    return {"us_per_iter": (ms[1] - ms[0]) * 1e3 / (ITERS - ITERS // 2), "checked": ok}


def main() -> int:
    if not torch.cuda.is_available():
        print("perf_cluster: no CUDA device; this runs only on a GPU", file=sys.stderr)
        return 1
    dll = build()
    rec = {"measure": "cluster_exchange", "n": N, "cluster": C, "threads": THREADS,
           "iters": ITERS}
    for blocks in (2 * 128, 2):
        rec[f"blocks_{blocks}"] = {name: time_mode(dll, mode, blocks)
                                   for mode, name in enumerate(MODES)}
    print(json.dumps(rec), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
