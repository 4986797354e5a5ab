// Batched exponential of small complex matrices: one thread per matrix,
// d in {2, 3, 4}.
//
// Replaces the Pallas TPU kernel mpc4quantum_tpu/ops/pallas_expm.py::_expm_kernel.
// With max_squarings > 0 each matrix takes its 1-norm,
// s = clip(ceil(log2(max(||A||_1, 1))), 0, max_squarings), scales A by 2^-s,
// runs the Horner Taylor of degree taylor_k (P = I + A P / k for k = K..1)
// and squares s times. max_squarings = 0 means the caller has certified
// ||A||_1 <= 1 (plants/quantum.py::taylor_norm_bound): no norm, no scaling,
// no squaring. The per-thread loop over its own s squarings gives the same
// result as the TPU kernel's masked squaring.
//
// Layout: re/im planes, each (d*d, B), element-major and lane-minor, so
// consecutive threads read consecutive addresses. A complex product is four
// real FMAs.
//
// What bounds it on the H100: a d = 2 matrix is 8 floats in and 8 out, with
// 8 complex FMAs a Taylor term; the whole chain lives in registers (at d = 4
// 96 floats a thread), so the kernel reads and writes each lane once and is
// bound by that traffic and by its serial chain of taylor_k + s products.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <int D>
__device__ __forceinline__ void cmatmul(const float* ar, const float* ai, const float* br,
                                        const float* bi, float* cr, float* ci) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float accr = ar[i * D] * br[j] - ai[i * D] * bi[j];
      float acci = ar[i * D] * bi[j] + ai[i * D] * br[j];
#pragma unroll
      for (int k = 1; k < D; ++k) {
        accr += ar[i * D + k] * br[k * D + j] - ai[i * D + k] * bi[k * D + j];
        acci += ar[i * D + k] * bi[k * D + j] + ai[i * D + k] * br[k * D + j];
      }
      cr[i * D + j] = accr;
      ci[i * D + j] = acci;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
expm_small_kernel(const float* __restrict__ ar_in, const float* __restrict__ ai_in,
                  float* __restrict__ or_out, float* __restrict__ oi_out, int B,
                  int taylor_k, int max_squarings) {
  constexpr int E = D * D;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float xr[E], xi[E], pr[E], pi[E], tr[E], ti[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    xr[e] = __ldg(ar_in + (size_t)e * B + b);
    xi[e] = __ldg(ai_in + (size_t)e * B + b);
  }

  int s = 0;
  if (max_squarings > 0) {
    float norm1 = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float col = 0.0f;
#pragma unroll
      for (int i = 0; i < D; ++i) col += sqrtf(xr[i * D + j] * xr[i * D + j] + xi[i * D + j] * xi[i * D + j]);
      norm1 = j == 0 ? col : fmaxf(norm1, col);
    }
    const float sc = fminf(fmaxf(ceilf(log2f(fmaxf(norm1, 1.0f))), 0.0f), (float)max_squarings);
    s = (int)sc;
    const float scale = exp2f(-sc);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      xr[e] *= scale;
      xi[e] *= scale;
    }
  }

  // Horner Taylor: P = I; for k = K..1: P = I + X P / k
#pragma unroll
  for (int e = 0; e < E; ++e) {
    pr[e] = (e % (D + 1) == 0) ? 1.0f : 0.0f;
    pi[e] = 0.0f;
  }
  for (int k = taylor_k; k >= 1; --k) {
    cmatmul<D>(xr, xi, pr, pi, tr, ti);
    const float inv_k = 1.0f / (float)k;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      pr[e] = ((e % (D + 1) == 0) ? 1.0f : 0.0f) + tr[e] * inv_k;
      pi[e] = ti[e] * inv_k;
    }
  }

  for (int step = 0; step < s; ++step) {
    cmatmul<D>(pr, pi, pr, pi, tr, ti);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      pr[e] = tr[e];
      pi[e] = ti[e];
    }
  }

#pragma unroll
  for (int e = 0; e < E; ++e) {
    or_out[(size_t)e * B + b] = pr[e];
    oi_out[(size_t)e * B + b] = pi[e];
  }
}

template <int D>
cudaError_t launch(const float* ar, const float* ai, float* out_r, float* out_i, int B,
                   int taylor_k, int max_squarings, cudaStream_t stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  expm_small_kernel<D><<<blocks, kThreads, 0, stream>>>(ar, ai, out_r, out_i, B, taylor_k,
                                                       max_squarings);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mpc4q_expm_small(const float* ar, const float* ai, float* out_r, float* out_i,
                                int B, int d, int taylor_k, int max_squarings, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (taylor_k < 1 || max_squarings < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 2: return launch<2>(ar, ai, out_r, out_i, B, taylor_k, max_squarings, s);
    case 3: return launch<3>(ar, ai, out_r, out_i, B, taylor_k, max_squarings, s);
    case 4: return launch<4>(ar, ai, out_r, out_i, B, taylor_k, max_squarings, s);
    default: return cudaErrorInvalidValue;
  }
}
