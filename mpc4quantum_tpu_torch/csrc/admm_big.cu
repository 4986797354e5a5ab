// Relaxed-ADMM iterations of a batch of box QPs from a precomputed K^-1:
// one thread block per QP (lane), any n up to 239.
//
// Replaces the Pallas TPU kernel
// mpc4quantum_tpu/ops/pallas_qp.py::_admm_loop_kernel (dispatched by
// `_admm_iters_lanes` for `boxqp_pallas_big`). Each lane runs `iters` steps
//     x = K^-1 (sigma x - q + rho z - y)
//     z = clip(alpha x + (1 - alpha) z + y / rho, lb, ub)
//     y = y + rho (z_arg - z)
// from the given K^-1 = (P + (sigma + rho) I)^-1, rho and (x, z, y); the
// inverse, the residuals and the rho rebalance run outside the kernel, as
// they do around the Pallas kernel (solvers/boxqp.py::solve_boxqp_fixed).
//
// Layout: K^-1 (B, n, n) row-major as the inverse functions return it,
// vectors (B, n), rho (B,): a lane's data is contiguous.
//
// What bounds it on the H100: each iteration is a serial chain of n FMAs
// per row over the lane's n x n K^-1 - a latency chain over on-chip data,
// not a stream of bytes (the inverse is read from device memory once per
// launch). The design gives each lane one block and each row one thread
// (x_i, z_i, y_i, q_i, lb_i, ub_i in registers), so the n rows run in
// parallel and the lanes fill the SMs; K^-1 sits in dynamic shared memory
// column-major with an odd column stride, so at a fixed column neighbouring
// threads read neighbouring words, and the transposing load is free of bank
// conflicts too. The right-hand side is exchanged through a shared vector,
// double-buffered so each iteration needs one barrier. The row sum runs in
// column order 0..n-1, the order of the Pallas column loop.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 239;            // K^-1 and the rhs fit 227 KB
constexpr size_t kDefaultSmem = 48 * 1024;

// NaN-propagating max, min and clip, matching jnp.maximum / jnp.minimum:
// fmaxf / fminf drop a NaN, and a NaN lane must never read as converged
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}

__host__ __device__ __forceinline__ int col_stride(int n) { return n | 1; }

__host__ __device__ __forceinline__ size_t smem_bytes(int n) {
  return sizeof(float) * ((size_t)n * col_stride(n) + 2 * (size_t)n);
}

__global__ void admm_big_kernel(const float* __restrict__ kinv,
                                const float* __restrict__ q_in,
                                const float* __restrict__ lb_in,
                                const float* __restrict__ ub_in,
                                const float* __restrict__ rho_in,
                                const float* __restrict__ x_in,
                                const float* __restrict__ z_in,
                                const float* __restrict__ y_in,
                                float* __restrict__ x_out, float* __restrict__ z_out,
                                float* __restrict__ y_out, int n, int iters, float sigma,
                                float alpha) {
  extern __shared__ float smem[];
  const int ld = col_stride(n);
  float* kcol = smem;           // kcol[j * ld + i] = K^-1[i, j]
  float* rhs = smem + n * ld;   // two buffers of n
  const size_t lane = blockIdx.x;
  const float* kin = kinv + lane * n * n;
  // coalesced read of the row-major inverse, stored column-major
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int r = e / n;
    kcol[(e - r * n) * ld + r] = __ldg(kin + e);
  }

  const int i = threadIdx.x;
  const bool own = i < n;  // threads past n only keep the barriers
  const size_t at = lane * n + i;
  float q = 0.f, lb = 0.f, ub = 0.f, x = 0.f, z = 0.f, y = 0.f;
  if (own) {
    q = __ldg(q_in + at);
    lb = __ldg(lb_in + at);
    ub = __ldg(ub_in + at);
    x = __ldg(x_in + at);
    z = __ldg(z_in + at);
    y = __ldg(y_in + at);
  }
  const float rho = __ldg(rho_in + lane);
  const float one_m_alpha = 1.0f - alpha;
  const float* col = kcol + i;
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    float* v = rhs + (it & 1) * n;
    if (own) v[i] = sigma * x - q + rho * z - y;
    __syncthreads();
    if (own) {
      float acc = col[0] * v[0];
#pragma unroll 8
      for (int j = 1; j < n; ++j) acc += col[j * ld] * v[j];
      x = acc;
      const float z_arg = alpha * x + one_m_alpha * z;
      const float z_new = nan_min(nan_max(z_arg + y / rho, lb), ub);
      y = y + rho * (z_arg - z_new);
      z = z_new;
    }
  }

  if (own) {
    x_out[at] = x;
    z_out[at] = z;
    y_out[at] = y;
  }
}

}  // namespace

extern "C" int mpc4q_admm_big(const float* kinv, const float* q, const float* lb,
                              const float* ub, const float* rho, const float* x,
                              const float* z, const float* y, float* x_out, float* z_out,
                              float* y_out, int B, int n, int iters, float sigma,
                              float alpha, void* stream) {
  if (n < 1 || n > kMaxN || iters < 0) return cudaErrorInvalidValue;
  if (B <= 0) return cudaSuccess;
  const size_t smem = smem_bytes(n);
  if (smem > kDefaultSmem) {
    // above 48 KB (n >= 110) dynamic shared memory must be opted into
    const cudaError_t attr = cudaFuncSetAttribute(
        admm_big_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return attr;
  }
  const int threads = (n + 31) / 32 * 32;
  admm_big_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      kinv, q, lb, ub, rho, x, z, y, x_out, z_out, y_out, n, iters, sigma, alpha);
  return cudaGetLastError();
}
