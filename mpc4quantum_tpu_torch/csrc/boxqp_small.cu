// Batched small box-QP solver: one thread per QP (lane), n <= 16.
//
// Replaces the Pallas TPU kernel mpc4quantum_tpu/ops/pallas_qp.py::_qp_kernel,
// in both its forms (the SCALED template flag). Each lane solves
//   min 1/2 x^T P x + q^T x  s.t.  lb <= x <= ub  by `rounds` rounds of
//   - an unpivoted Gauss-Jordan inverse of K = P + (sigma + rho) I,
//   - `iters` relaxed ADMM steps
//       x = K^-1 (sigma x - q + rho z - y)
//       z = clip(alpha x + (1 - alpha) z + y / rho, lb, ub)
//       y = y + rho (z_arg - z),
//   - the residuals, the acceptance test and the OSQP rho rebalance, which
//     is frozen once the round is accepted,
// in the same order as the Pallas kernel and the plain version
// (solvers/boxqp.py::solve_boxqp_fixed). In the scaled form the QP arrives
// Jacobi-equilibrated (the wrapper scales it, as `boxqp_pallas` does) with
// its weights d; the residual statistics are then reported in the original
// coordinates - primal rows times d, dual rows divided by d. d is read from
// global memory inside the residual block, which runs once per round, and
// is held in no register array.
//
// Layout: structure of arrays, element-major and lane-minor - P is (n*n, B),
// vectors and d (n, B), rho0 (B,), aux (8, B) - so consecutive threads read
// consecutive addresses.
//
// What bounds it on the H100: at the flagship n = 10 a lane needs ~300
// floats (P, K^-1, iterates) against a 255-register limit per thread, and
// the ADMM loop is a serial chain of n^2 FMAs per step. The design keeps the
// iterates and bounds in registers, reads P from global memory (only to form
// K and the residual P x, once per round), and holds K^-1 in dynamic shared
// memory, laid out [element][thread] so a warp's accesses hit 32 banks. The
// Gauss-Jordan elimination runs in place on that n^2 block (the [K | I]
// augmented form gives the same values). The kernel is latency-bound; the
// lane count is the parallelism.
//
// P's loads do not depend on the round, so the compiler hoists all n^2 of
// them, values and 64-bit addresses, out of the round loop. From n = 11 up
// that overflows the register file: at n = 15 ptxas fell back to 32
// registers and 6 KB of spill stores, at twice the time. There an empty asm
// that "changes" P's pointer at the top of each round keeps the loads inside
// the round (n = 15: 255 registers, 1.4 KB of spill stores). The n <= 10
// instances are built as before.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kAuxRows = 8;

// NaN-propagating max and clip, matching jnp.maximum / jnp.clip: a NaN lane
// must never read as converged.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <int N, bool SCALED>
__global__ void __launch_bounds__(kThreads)
boxqp_small_kernel(const float* __restrict__ P, const float* __restrict__ q_in,
                   const float* __restrict__ lb_in, const float* __restrict__ ub_in,
                   const float* __restrict__ x0_in, const float* __restrict__ y0_in,
                   const float* __restrict__ rho0_in, const float* __restrict__ d_in,
                   float* __restrict__ z_out, float* __restrict__ y_out,
                   float* __restrict__ aux_out, int B,
                   int iters, int rounds, float rho_scale, float sigma, float alpha,
                   float eps_abs, float eps_rel, float acc_abs, float acc_rel) {
  extern __shared__ float smem[];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;  // no block-wide barrier below
  const int T = blockDim.x;
  float* kinv = smem + threadIdx.x;  // element e of this lane at kinv[e * T]
#define KI(i, j) kinv[((i) * N + (j)) * T]
#define PE(i, j) __ldg(Pp + (size_t)((i) * N + (j)) * B + b)
#define DE(i) __ldg(d_in + (size_t)(i) * B + b)

  const float* Pp = P;
  float q[N], lb[N], ub[N], x[N], z[N], y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    q[i] = __ldg(q_in + (size_t)i * B + b);
    lb[i] = __ldg(lb_in + (size_t)i * B + b);
    ub[i] = __ldg(ub_in + (size_t)i * B + b);
    // warm start clipped into the box; the dual from the carried y0
    x[i] = clip(__ldg(x0_in + (size_t)i * B + b), lb[i], ub[i]);
    z[i] = x[i];
    y[i] = __ldg(y0_in + (size_t)i * B + b);
  }

  // rho: rho_scale * mean(diag P); a carried rho0 > 0 overrides it, clipped
  // to the adaptation range
  float diag_sum = PE(0, 0);
#pragma unroll
  for (int i = 1; i < N; ++i) diag_sum += PE(i, i);
  const float diag_scale = nan_max(diag_sum / (float)N, 1e-12f);
  const float lo = 1e-8f * diag_scale, hi = 1e8f * diag_scale;
  const float rho_c = __ldg(rho0_in + b);
  float rho = rho_c > 0.0f ? clip(rho_c, lo, hi) : rho_scale * diag_scale;

  float qmax = SCALED ? __fdividef(fabsf(q[0]), DE(0)) : fabsf(q[0]);
#pragma unroll
  for (int i = 1; i < N; ++i) {
    qmax = nan_max(qmax, SCALED ? __fdividef(fabsf(q[i]), DE(i)) : fabsf(q[i]));
  }
  float prim = 0.f, dual = 0.f, xmax = 0.f, zmax = 0.f, pxmax = 0.f, ymax = 0.f;
  const float one_m_alpha = 1.0f - alpha;

  for (int rnd = 0; rnd < rounds; ++rnd) {
    if constexpr (N > 10) asm volatile("" : "+l"(Pp));
    // K^-1 by in-place unpivoted Gauss-Jordan on K = P + (sigma + rho) I
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) KI(i, j) = (i == j) ? PE(i, j) + sigma + rho : PE(i, j);
    }
    // the elimination runs once per round: its row loops stay rolled (an
    // unrolled n^3 body multiplies the build time for nothing)
#pragma unroll 1
    for (int c = 0; c < N; ++c) {
      const float piv = 1.0f / KI(c, c);
      KI(c, c) = 1.0f;
#pragma unroll
      for (int j = 0; j < N; ++j) KI(c, j) *= piv;
#pragma unroll 1
      for (int r = 0; r < N; ++r) {
        if (r == c) continue;
        const float f = KI(r, c);
        KI(r, c) = 0.0f;
#pragma unroll
        for (int j = 0; j < N; ++j) KI(r, j) -= f * KI(c, j);
      }
    }

    for (int it = 0; it < iters; ++it) {
      float rhs[N];
#pragma unroll
      for (int i = 0; i < N; ++i) rhs[i] = sigma * x[i] - q[i] + rho * z[i] - y[i];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float acc = KI(i, 0) * rhs[0];
#pragma unroll
        for (int j = 1; j < N; ++j) acc += KI(i, j) * rhs[j];
        x[i] = acc;
      }
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float z_arg = alpha * x[i] + one_m_alpha * z[i];
        const float z_new = clip(z_arg + y[i] / rho, lb[i], ub[i]);
        y[i] = y[i] + rho * (z_arg - z_new);
        z[i] = z_new;
      }
    }

    // residuals in inf-norm, acceptance, and the rho rebalance
    prim = dual = xmax = zmax = pxmax = ymax = 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float px = PE(i, 0) * x[0];
#pragma unroll
      for (int j = 1; j < N; ++j) px += PE(i, j) * x[j];
      float r_prim = fabsf(x[i] - z[i]), r_dual = fabsf(px + q[i] + y[i]);
      float r_x = fabsf(x[i]), r_z = fabsf(z[i]), r_px = fabsf(px), r_y = fabsf(y[i]);
      if (SCALED) {
        // |d v| = d |v| and |v / d| = |v| / d, for d > 0. __fdividef (2 ulp)
        // has no out-of-line slow path: the IEEE division's call doubled
        // the spills of the whole kernel
        const float di = DE(i);
        r_prim *= di;
        r_x *= di;
        r_z *= di;
        r_dual = __fdividef(r_dual, di);
        r_px = __fdividef(r_px, di);
        r_y = __fdividef(r_y, di);
      }
      if (i == 0) {
        prim = r_prim;
        dual = r_dual;
        xmax = r_x;
        zmax = r_z;
        pxmax = r_px;
        ymax = r_y;
      } else {
        prim = nan_max(prim, r_prim);
        dual = nan_max(dual, r_dual);
        xmax = nan_max(xmax, r_x);
        zmax = nan_max(zmax, r_z);
        pxmax = nan_max(pxmax, r_px);
        ymax = nan_max(ymax, r_y);
      }
    }
    const float pscale = nan_max(xmax, zmax);
    const float dscale = nan_max(pxmax, nan_max(qmax, ymax));
    const bool accepted =
        prim <= nan_max(eps_abs + eps_rel * pscale, acc_abs + acc_rel * pscale) &&
        dual <= nan_max(eps_abs + eps_rel * dscale, acc_abs + acc_rel * dscale);
    if (!accepted) {
      const float prim_s = prim / nan_max(pscale, 1e-12f);
      const float dual_s = dual / nan_max(dscale, 1e-12f);
      const float ratio = sqrtf(prim_s / nan_max(dual_s, 1e-16f));
      rho = clip(rho * ratio, lo, hi);
    }
  }

#pragma unroll
  for (int i = 0; i < N; ++i) {
    z_out[(size_t)i * B + b] = z[i];
    y_out[(size_t)i * B + b] = y[i];
  }
  const float aux[kAuxRows] = {prim, dual, xmax, zmax, pxmax, qmax, ymax, rho};
#pragma unroll
  for (int r = 0; r < kAuxRows; ++r) aux_out[(size_t)r * B + b] = aux[r];
#undef KI
#undef PE
#undef DE
}

template <int N, bool SCALED>
cudaError_t launch(const float* P, const float* q, const float* lb, const float* ub,
                   const float* x0, const float* y0, const float* rho0, const float* d,
                   float* z, float* y, float* aux, int B, int iters, int rounds,
                   float rho_scale, float sigma, float alpha, float eps_abs, float eps_rel,
                   float acc_abs, float acc_rel, cudaStream_t stream) {
  const size_t smem = sizeof(float) * N * N * kThreads;
  // above 48 KB (n >= 14) dynamic shared memory must be opted into
  static const cudaError_t attr = cudaFuncSetAttribute(
      boxqp_small_kernel<N, SCALED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const int blocks = (B + kThreads - 1) / kThreads;
  boxqp_small_kernel<N, SCALED><<<blocks, kThreads, smem, stream>>>(
      P, q, lb, ub, x0, y0, rho0, d, z, y, aux, B, iters, rounds, rho_scale, sigma, alpha,
      eps_abs, eps_rel, acc_abs, acc_rel);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mpc4q_boxqp_small(const float* P, const float* q, const float* lb,
                                 const float* ub, const float* x0, const float* y0,
                                 const float* rho0, const float* d, float* z, float* y,
                                 float* aux, int B, int n, int iters, int rounds,
                                 float rho_scale, float sigma, float alpha, float eps_abs,
                                 float eps_rel, float acc_abs, float acc_rel, void* stream) {
  if (B <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // d == nullptr selects the unscaled form
#define CASE(NN)                                                                      \
  case NN:                                                                            \
    return d ? launch<NN, true>(P, q, lb, ub, x0, y0, rho0, d, z, y, aux, B, iters,   \
                                rounds, rho_scale, sigma, alpha, eps_abs, eps_rel,     \
                                acc_abs, acc_rel, s)                                   \
             : launch<NN, false>(P, q, lb, ub, x0, y0, rho0, d, z, y, aux, B, iters,  \
                                 rounds, rho_scale, sigma, alpha, eps_abs, eps_rel,    \
                                 acc_abs, acc_rel, s);
  switch (n) {
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef CASE
}
