#!/usr/bin/env python3
"""admm_big's streaming instance (n > 1008) against a prototype that
streams K^-1 with TMA bulk copies, on one CUDA card.

The instance in csrc/admm_big.cu reads each CTA's rows of K^-1 every
iteration with plain coalesced loads straight into registers (`__ldg`, four
rows a warp, up to 16 loads in flight a thread). The prototype here
(`stream_tma_kernel`, built from this file's source together with
csrc/admm_big.cu, whose exchange and mbarrier helpers it uses) keeps the same
cluster of 16 CTAs a lane, rows a CTA, rhs exchange by st.async and update;
only the K^-1 reads differ: each warp streams its groups of four rows in
segments of 256 columns through its own ring of `nst` shared-memory slots
(as many as fit beside the rhs buffers, 2-4), one mbarrier a slot, lane 0
issuing one cp.async.bulk a row a segment ahead of the warp's use. A row of
K^-1 starts 16-byte aligned only when n % 4 == 0, so each copy takes the
aligned span that covers the row's segment (up to 3 floats on each side)
and the warp reads past the head; where that span would pass the end of the
tensor, the last floats are read from global memory directly.

    python3 perf_stream.py

For each (B, n, iters): both kernels' device time (CUDA graph of 20 calls,
CUDA events), their largest error relative to the plain version
(kernels/admm_big.admm_iters_ref), the function's bound and the streaming
instance's own bytes bound (K^-1 read every iteration). One JSON line a
shape, then the card's name and power limit. Without a CUDA device it
exits 1.
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

SHAPES = ((1, 1024, 10), (16, 1009, 50), (16, 1024, 50), (4, 2048, 20), (2, 4096, 10),
          (1, 8191, 4))

SOURCE = r"""
#include "%(src)s"

namespace {

constexpr int kTmaRows = 4;    // rows a slot: a warp's group
constexpr int kTmaSeg = 256;   // columns a segment
constexpr int kTmaPad = 8;     // the aligned span's extra floats, rounded to 16 bytes
constexpr int kWarps = kStreamThreads / 32;
constexpr int kSlotFloats = kTmaRows * (kTmaSeg + kTmaPad);

__device__ __forceinline__ void bulk_g2s(uint32_t dst, const float* src, int bytes,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%%0], [%%1], %%2, [%%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// one row segment of a slot: its first float in the tensor (G), the aligned
// span's first float (A0) and the floats of the segment the span holds
struct Seg {
  size_t G, A0;
  int held;
};

__device__ __forceinline__ Seg seg_of(size_t G, int len, size_t total) {
  const size_t A0 = G & ~(size_t)3;
  size_t A1 = (G + len + 3) & ~(size_t)3;
  if (A1 > total) A1 = total & ~(size_t)3;
  const long long held = (long long)A1 - (long long)G;
  return {G, A0, held < 0 ? 0 : (held > len ? len : (int)held)};
}

__global__ void __launch_bounds__(kStreamThreads, 1)
stream_tma_kernel(const float* __restrict__ kinv, const float* __restrict__ q_in,
                  const float* __restrict__ lb_in, const float* __restrict__ ub_in,
                  const float* __restrict__ rho_in, const float* __restrict__ x_in,
                  const float* __restrict__ z_in, const float* __restrict__ y_in,
                  float* __restrict__ x_out, float* __restrict__ z_out,
                  float* __restrict__ y_out, int n, int iters, float sigma, float alpha,
                  int nst) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const size_t lane = blockIdx.x / c;
  const size_t total = (size_t)(gridDim.x / c) * n * n;
  const int R = cluster_rows(n, c), r0 = rank * R;
  const int rows = n - r0 < R ? n - r0 : R;
  const int t = threadIdx.x, T = blockDim.x, warp = t / 32, l32 = t %% 32;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const int nbars = 2 + kWarps * nst;
  float* rhs = smem + (2 * nbars + 3) / 4 * 4;
  float* slots = rhs + (2 * n + 3) / 4 * 4 + warp * nst * kSlotFloats;
  const size_t base = lane * n;
  const float* q = q_in + base;
  const float* lb = lb_in + base;
  const float* ub = ub_in + base;
  float* x = x_out + base;
  float* z = z_out + base;
  float* y = y_out + base;
  const float rho = __ldg(rho_in + lane);
  const float one_m_alpha = 1.0f - alpha;
  for (int i = t; i < rows; i += T) {
    const int r = r0 + i;
    x[r] = __ldg(x_in + base + r);
    z[r] = __ldg(z_in + base + r);
    y[r] = __ldg(y_in + base + r);
  }
  const uint32_t bar0 = smem_u32(bars), bar1 = smem_u32(bars + 1);
  const uint32_t sbar = smem_u32(bars + 2 + warp * nst);
  if (t == 0) init_bars(bar0, bar1);
  if (l32 == 0) {
    for (int s = 0; s < nst; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%%0], 1;" ::"r"(sbar + 8 * s) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();
  auto post = [&](int it) {
    float* v = rhs + (it & 1) * n;
    const uint32_t bar = it & 1 ? bar1 : bar0;
    if (t == 0) expect_bytes(bar, 4 * n);
    for (int i = t; i < rows; i += T) {
      const int r = r0 + i;
      const float vr = sigma * x[r] - __ldg(q + r) + rho * z[r] - y[r];
      for (int dst = 0; dst < c; ++dst) send(smem_u32(v + r), bar, dst, vr);
    }
  };
  // this warp's groups of kTmaRows rows (g = warp, warp + kWarps, ...), each
  // in nseg segments: per_it items an iteration, in the same order every
  // iteration; the producer (lane 0) runs nst items ahead of the warp
  const int groups = (rows + kTmaRows - 1) / kTmaRows;
  const int mine = warp < groups ? (groups - warp + kWarps - 1) / kWarps : 0;
  const int nseg = (n + kTmaSeg - 1) / kTmaSeg;
  const long long items = (long long)mine * nseg * iters;
  const size_t lane_off = lane * n * n;
  const float* klane = kinv + lane_off;
  int pk = 0, ps = 0, pslot = 0;
  long long issued = 0;
  auto issue_next = [&]() {
    const int grp = warp + kWarps * pk, c0 = ps * kTmaSeg;
    const int len = n - c0 < kTmaSeg ? n - c0 : kTmaSeg;
    const int nr = rows - grp * kTmaRows < kTmaRows ? rows - grp * kTmaRows : kTmaRows;
    const uint32_t bar = sbar + 8 * pslot;
    float* slot = slots + pslot * kSlotFloats;
    int bytes = 0, span[kTmaRows];
    size_t A0[kTmaRows];
    for (int j = 0; j < nr; ++j) {
      const Seg sg = seg_of(lane_off + (size_t)(r0 + grp * kTmaRows + j) * n + c0, len, total);
      A0[j] = sg.A0;
      span[j] = sg.held > 0 ? (int)((sg.G + sg.held + 3) / 4 * 4 - sg.A0) : 0;
      bytes += 4 * span[j];
    }
    expect_bytes(bar, bytes);
    for (int j = 0; j < nr; ++j)
      if (span[j] > 0)
        bulk_g2s(smem_u32(slot + j * (kTmaSeg + kTmaPad)), kinv + A0[j], 4 * span[j], bar);
    ++issued;
    if (++pslot == nst) pslot = 0;
    if (++ps == nseg) {
      ps = 0;
      if (++pk == mine) pk = 0;
    }
  };
  if (iters > 0) post(0);
  if (l32 == 0)
    while (issued < nst && issued < items) issue_next();
  int cslot = 0;
  uint32_t phases = 0;  // bit s: the parity of slot s's next phase
  for (int it = 0; it < iters; ++it) {
    wait_phase(it & 1 ? bar1 : bar0, (it >> 1) & 1);
    const float* v = rhs + (it & 1) * n;
    for (int k = 0; k < mine; ++k) {
      const int grp = warp + kWarps * k;
      const int nr = rows - grp * kTmaRows < kTmaRows ? rows - grp * kTmaRows : kTmaRows;
      float acc[kTmaRows];
#pragma unroll
      for (int j = 0; j < kTmaRows; ++j) acc[j] = 0.0f;
      for (int sgi = 0; sgi < nseg; ++sgi) {
        const int c0 = sgi * kTmaSeg;
        const int len = n - c0 < kTmaSeg ? n - c0 : kTmaSeg;
        wait_phase(sbar + 8 * cslot, (phases >> cslot) & 1);
        phases ^= 1u << cslot;
        const float* slot = slots + cslot * kSlotFloats;
        int off[kTmaRows], held[kTmaRows];
#pragma unroll
        for (int j = 0; j < kTmaRows; ++j) {
          const Seg sg = seg_of(lane_off + (size_t)(r0 + grp * kTmaRows + j) * n + c0, len,
                                total);
          off[j] = j * (kTmaSeg + kTmaPad) + (int)(sg.G - sg.A0);
          held[j] = j < nr ? sg.held : 0;
        }
        const float* kcol = klane + (size_t)(r0 + grp * kTmaRows) * n + c0;
        for (int e = l32; e < len; e += 32) {
          const float vc = v[c0 + e];
#pragma unroll
          for (int j = 0; j < kTmaRows; ++j) {
            if (j < nr) {
              const float kv = e < held[j] ? slot[off[j] + e] : __ldg(kcol + (size_t)j * n + e);
              acc[j] = fmaf(kv, vc, acc[j]);
            }
          }
        }
        __syncwarp();
        if (l32 == 0 && issued < items) issue_next();
        if (++cslot == nst) cslot = 0;
      }
      float got = 0.0f;
#pragma unroll
      for (int j = 0; j < kTmaRows; ++j) {
        for (int m = 16; m > 0; m >>= 1) acc[j] += __shfl_xor_sync(kFull, acc[j], m);
        if (l32 == j) got = acc[j];
      }
      if (l32 < nr) {
        const int r = r0 + grp * kTmaRows + l32;
        const float zr = z[r], yr = y[r];
        const float z_arg = alpha * got + one_m_alpha * zr;
        const float z_new = nan_min(nan_max(z_arg + yr / rho, __ldg(lb + r)), __ldg(ub + r));
        x[r] = got;
        z[r] = z_new;
        y[r] = yr + rho * (z_arg - z_new);
      }
    }
    if (it + 1 < iters) {
      __syncthreads();
      post(it + 1);
    }
  }
  cluster.sync();
}

}  // namespace

extern "C" int probe_stream_tma(const float* kinv, const float* q, const float* lb,
                                const float* ub, const float* rho, const float* x,
                                const float* z, const float* y, float* x_out, float* z_out,
                                float* y_out, int B, int n, int iters, float sigma, float alpha,
                                void* stream, int* nst_out) {
  const int head = 4 * ((2 * (2 + kWarps * 4) + 3) / 4 * 4) + 4 * ((2 * n + 3) / 4 * 4);
  int nst = (kMaxSmem - head) / (4 * kWarps * kSlotFloats);
  if (nst > 4) nst = 4;
  *nst_out = nst;
  if (nst < 2) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(stream_tma_kernel,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(stream_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute at;
  cudaLaunchConfig_t cfg = stream_config(B, n, true, static_cast<cudaStream_t>(stream), &at);
  cfg.dynamicSmemBytes = head + 4 * kWarps * nst * kSlotFloats;
  return cudaLaunchKernelEx(&cfg, stream_tma_kernel, kinv, q, lb, ub, rho, x, z, y, x_out,
                            z_out, y_out, n, iters, sigma, alpha, nst);
}
"""


def build() -> ctypes.CDLL:
    BUILD.mkdir(exist_ok=True)
    src = BUILD / "perf_stream_probe.cu"
    src.write_text(SOURCE % {"src": ROOT / "mpc4quantum_tpu_torch" / "csrc" / "admm_big.cu"})
    lib = BUILD / "perf_stream_probe.so"
    proc = subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                           "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared",
                           "-o", str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    spills = [line for line in proc.stderr.splitlines()
              if "stream_tma" in line or ("spill" in line and " 0 bytes spill" not in line)]
    print(json.dumps({"build": "ok", "ptxas": spills[:6]}), flush=True)
    dll = ctypes.CDLL(str(lib))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.probe_stream_tma.argtypes = [P] * 11 + [I] * 3 + [F] * 2 + [P, ctypes.POINTER(I)]
    dll.probe_stream_tma.restype = I
    return dll


def main() -> int:
    if not torch.cuda.is_available():
        print("perf_stream: no CUDA device; this runs only on a GPU", file=sys.stderr)
        return 1
    from mpc4quantum_tpu_torch.kernels import admm_big as admm_mod
    from mpc4quantum_tpu_torch.utils.linalg import gj_inverse

    dll = build()
    for B, n, iters in SHAPES:
        args, kw = cs.admm_input(B, n, iters, gj_inverse)
        ref = admm_mod.admm_iters_ref(*args, **kw)
        outs = [torch.empty_like(args[1]) for _ in range(3)]
        nst = ctypes.c_int(0)

        def tma():
            stream = torch.cuda.current_stream().cuda_stream
            rc = dll.probe_stream_tma(*(a.data_ptr() for a in args),
                                      *(o.data_ptr() for o in outs), B, n, iters,
                                      kw["sigma"], kw["alpha"], stream, ctypes.byref(nst))
            if rc != 0:
                raise RuntimeError(f"stream_tma: CUDA error {rc}")

        lib = lambda: admm_mod.admm_big(*args, **kw)
        tma()
        got = {"library": lib(), "tma": tuple(outs)}
        torch.cuda.synchronize()
        rec = {"B": B, "n": n, "iters": iters, "plan": admm_mod.admm_big_plan(B, n)._asdict(),
               "tma_slots": nst.value}
        for name, out in got.items():
            rec[f"{name}_rel_err"] = max(float((a - b).abs().max() / max(1.0, float(b.abs().max())))
                                         for a, b in zip(out, ref))
        rec["library_us"] = cs.graph_us(lib)
        rec["tma_us"] = cs.graph_us(tma)
        flops, nbytes = admm_mod.admm_big_work(B, n, iters)
        rec["bound_us"] = max(nbytes / cs.PEAK_BYTES, flops / cs.PEAK_FLOPS) * 1e6
        rec["own_bytes_bound_us"] = admm_mod.stream_bytes(B, n, iters) / cs.PEAK_BYTES * 1e6
        print(json.dumps(rec), flush=True)
        cs.require(rec["tma_rel_err"] <= cs.ADMM_TOL and rec["library_rel_err"] <= cs.ADMM_TOL,
                   f"perf_stream: {rec}")
    print(cs.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
