// Batched small box-QP solver: a team of W threads per QP (lane), n <= 16.
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
// with the operations on each element in the order of the Pallas kernel and
// of the plain version (solvers/boxqp.py::solve_boxqp_fixed with the
// Gauss-Jordan inverse of utils/linalg.py::gj_inverse). The kernel also
// symmetrizes P, 0.5 (P_rj + P_jr), and in the scaled form Jacobi-equilibrates
// the QP (d_r = 1 / sqrt(max(P_rr, 1e-12)), P_rj d_r d_j, q d, lb / d, ub / d,
// x0 / d, y0 d, as solvers/boxqp.py::jacobi_scale_boxqp), reports the residual
// statistics in the original coordinates (primal rows times d, dual rows
// divided by d) and unscales z d and y / d: one launch is the whole solve.
//
// Layout: the runner's. P (B, n, n) row-major, q, lb, ub, x0, y0, z, y (B, n),
// rho0 (B,), aux (8, B); a null x0, y0 or rho0 is a zero warm start (rho0 = 0
// selects the cold default rho_scale * mean(diag P)).
//
// Work per lane, FMA = 2 flops: rounds * (2n^3 + iters (2n^2 + 8n) + 2n^2
// + 12n) flops against 4 (n^2 + 7n + 9) bytes; at the flagship's n = 10,
// 3 x 12, B = 16384, 279 MFLOP (4.2 us at 67 TFLOP/s) and 11.7 MB (3.5 us at
// 3.35 TB/s). The bound is the operations; the real limits are below.
//
// Design. The one-thread-per-QP design of the first port needed ~300 floats
// a thread against 255 registers (336 B of spills at n = 10, 1.4 KB at
// n = 15), kept K^-1 in a [element][thread] shared block (57.6 KB a block of
// 64 threads at n = 15, so not_gate's B = 1024 ran 16 blocks on 16 of 132
// SMs) and ran each ADMM step as one thread's serial chain of n^2 FMAs. Here
// a team of W threads, W the power of two >= n, solves one QP: thread r owns
// row r and keeps row r of P, row r of K^-1 and x_r, z_r, y_r, q_r, lb_r,
// ub_r (and d_r) in registers, about 3n + 20 of them, with no spills and no
// per-QP shared block. A warp holds 32 / W QPs and a block of 128 threads
// 128 / W, so B = 1024 at n = 15 spreads over 128 blocks. Threads r >= n only
// take part in the exchanges and hold zeros (neutral in every sum and
// maximum, never NaN); at n = 10, 6 of 16 threads idle, the price of
// power-of-two shuffle segments.
// - Gauss-Jordan by rows: for each pivot column c the owner of row c scales
//   it by 1 / K(c, c); every other row takes f = K(r, c), sets K(r, c) = 0
//   and subtracts f times the pivot row - the in-place form of [K | I].
// - A vector the whole team needs (the pivot row, the ADMM right-hand side,
//   x for P x, the Jacobi weights, the diagonal) goes through a per-team
//   slot of shared memory after a __syncwarp and is read back as float4
//   broadcasts: n / 4 loads instead of n shuffles, which at B = 16384 would
//   make the shuffle unit set the pace. Two slots alternate, so one
//   __syncwarp an exchange suffices.
// - The six residual maxima reduce over the team by a __shfl_xor_sync
//   butterfly with the NaN-propagating max: a NaN lane never reads as
//   accepted. Every thread of a team then holds the same rho, acceptance
//   and rebalance; thread 0 of the team writes aux.
// A team past the end of the batch solves the last QP again and stores
// nothing, so every thread reaches every __syncwarp.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kAuxRows = 8;
constexpr unsigned kFull = 0xffffffffu;

// NaN-propagating max and clip, matching jnp.maximum / jnp.clip: a NaN lane
// must never read as converged.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__host__ __device__ constexpr int team_width(int n) {
  return n <= 1 ? 1 : n <= 2 ? 2 : n <= 4 ? 4 : n <= 8 ? 8 : 16;
}

// an index kept inside [0, n): the masked entries of a float4 never read
// past a register array
__host__ __device__ constexpr int cap(int i, int n) { return i < n ? i : n - 1; }

// The team's exchange: slot s of the team (S4 floats, float4-aligned) takes
// one value per thread r < N; after the __syncwarp every thread reads all N.
template <int N>
struct Team {
  static constexpr int W = team_width(N);
  static constexpr int S4 = (N + 3) / 4 * 4;
  float* slots;  // two slots of S4 floats
  int phase;
  int r;

  __device__ __forceinline__ float* next() {
    float* s = slots + phase * S4;
    phase ^= 1;
    return s;
  }

  __device__ __forceinline__ void read(const float* s, float (&out)[N]) const {
    const float4* s4 = reinterpret_cast<const float4*>(s);
#pragma unroll
    for (int k = 0; k < S4 / 4; ++k) {
      const float4 t = s4[k];
      if (4 * k + 0 < N) out[cap(4 * k + 0, N)] = t.x;
      if (4 * k + 1 < N) out[cap(4 * k + 1, N)] = t.y;
      if (4 * k + 2 < N) out[cap(4 * k + 2, N)] = t.z;
      if (4 * k + 3 < N) out[cap(4 * k + 3, N)] = t.w;
    }
  }

  // every thread's value v (threads r >= N write nothing) -> out[0..N)
  __device__ __forceinline__ void share(float v, float (&out)[N]) {
    float* s = next();
    if (r < N) s[r] = v;
    __syncwarp();
    read(s, out);
  }

  // the team's maximum by a butterfly over its W threads
  __device__ __forceinline__ static float max(float v) {
#pragma unroll
    for (int m = W / 2; m > 0; m >>= 1) v = nan_max(v, __shfl_xor_sync(kFull, v, m, W));
    return v;
  }
};

template <int N, bool SCALED>
__global__ void __launch_bounds__(kThreads)
boxqp_small_kernel(const float* __restrict__ P_in, const float* __restrict__ q_in,
                   const float* __restrict__ lb_in, const float* __restrict__ ub_in,
                   const float* __restrict__ x0_in, const float* __restrict__ y0_in,
                   const float* __restrict__ rho0_in, float* __restrict__ z_out,
                   float* __restrict__ y_out, float* __restrict__ aux_out, int B,
                   int iters, int rounds, float rho_scale, float sigma, float alpha,
                   float eps_abs, float eps_rel, float acc_abs, float acc_rel) {
  using T = Team<N>;
  constexpr int TEAMS = kThreads / T::W;
  __shared__ __align__(16) float slots[TEAMS][2 * T::S4];

  const int team = threadIdx.x / T::W;
  const int r = threadIdx.x % T::W;
  const int b_team = blockIdx.x * TEAMS + team;
  const bool store = b_team < B;
  const int b = store ? b_team : B - 1;
  const bool live = r < N;
  const int rr = live ? r : 0;  // idle threads address row 0 and load nothing
  T tm{slots[team], 0, r};

  // row r of the symmetrized P; idle threads hold zeros
  const float* Pb = P_in + (size_t)b * N * N;
  const size_t at = (size_t)b * N + rr;
  float prow[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    prow[j] = live ? 0.5f * (__ldg(Pb + rr * N + j) + __ldg(Pb + j * N + rr)) : 0.0f;
  }
  float diag = 0.0f;  // P_rr, selected without a dynamic register index
#pragma unroll
  for (int j = 0; j < N; ++j) diag = (j == r) ? prow[j] : diag;

  float q = live ? __ldg(q_in + at) : 0.0f;
  float lb = live ? __ldg(lb_in + at) : 0.0f;
  float ub = live ? __ldg(ub_in + at) : 0.0f;
  float x0 = (live && x0_in) ? __ldg(x0_in + at) : 0.0f;
  float y = (live && y0_in) ? __ldg(y0_in + at) : 0.0f;
  float d = 1.0f;
  float v[N];  // the team's vector of the current exchange
  if (SCALED) {
    // Jacobi weights on the symmetrized diagonal, in jacobi_scale_boxqp's order
    if (live) d = 1.0f / sqrtf(nan_max(diag, 1e-12f));
    tm.share(d, v);
#pragma unroll
    for (int j = 0; j < N; ++j) prow[j] = prow[j] * d * v[j];
    diag = diag * d * d;
    q = q * d;
    lb = lb / d;
    ub = ub / d;
    if (x0_in) x0 = x0 / d;
    if (y0_in) y = y * d;
  }

  // rho: rho_scale * mean(diag P), the diagonal summed in order 0..n-1; a
  // carried rho0 > 0 overrides it, clipped to the adaptation range
  tm.share(diag, v);
  float diag_sum = v[0];
#pragma unroll
  for (int j = 1; j < N; ++j) diag_sum += v[j];
  const float diag_scale = nan_max(diag_sum / (float)N, 1e-12f);
  const float lo = 1e-8f * diag_scale, hi = 1e8f * diag_scale;
  const float rho_c = rho0_in ? __ldg(rho0_in + b) : 0.0f;
  float rho = rho_c > 0.0f ? clip(rho_c, lo, hi) : rho_scale * diag_scale;

  // warm start clipped into the box; the dual from the carried y0
  float x = clip(x0, lb, ub), z = x;
  const float qmax = T::max(SCALED ? fabsf(q) / d : fabsf(q));
  float prim = 0.f, dual = 0.f, xmax = 0.f, zmax = 0.f, pxmax = 0.f, ymax = 0.f;
  const float one_m_alpha = 1.0f - alpha;

  for (int rnd = 0; rnd < rounds; ++rnd) {
    // row r of K^-1 by in-place Gauss-Jordan on K = P + (sigma + rho) I
    float k[N];
#pragma unroll
    for (int j = 0; j < N; ++j) k[j] = (j == r) ? prow[j] + sigma + rho : prow[j];
#pragma unroll
    for (int c = 0; c < N; ++c) {
      float* s = tm.next();
      if (r == c) {
        const float piv = 1.0f / k[c];
        k[c] = 1.0f;
#pragma unroll
        for (int j = 0; j < N; ++j) k[j] *= piv;
        float4* s4 = reinterpret_cast<float4*>(s);
#pragma unroll
        for (int j4 = 0; j4 < T::S4 / 4; ++j4) {
          s4[j4] = make_float4(4 * j4 + 0 < N ? k[cap(4 * j4 + 0, N)] : 0.0f,
                               4 * j4 + 1 < N ? k[cap(4 * j4 + 1, N)] : 0.0f,
                               4 * j4 + 2 < N ? k[cap(4 * j4 + 2, N)] : 0.0f,
                               4 * j4 + 3 < N ? k[cap(4 * j4 + 3, N)] : 0.0f);
        }
      }
      __syncwarp();
      tm.read(s, v);
      if (live && r != c) {
        const float f = k[c];
        k[c] = 0.0f;
#pragma unroll
        for (int j = 0; j < N; ++j) k[j] -= f * v[j];
      }
    }

    for (int it = 0; it < iters; ++it) {
      tm.share(sigma * x - q + rho * z - y, v);
      float acc = k[0] * v[0];
#pragma unroll
      for (int j = 1; j < N; ++j) acc += k[j] * v[j];
      x = acc;
      const float z_arg = alpha * x + one_m_alpha * z;
      const float z_new = clip(z_arg + y / rho, lb, ub);
      y = y + rho * (z_arg - z_new);
      z = z_new;
    }

    // residuals in inf-norm, acceptance, and the rho rebalance
    tm.share(x, v);
    float px = prow[0] * v[0];
#pragma unroll
    for (int j = 1; j < N; ++j) px += prow[j] * v[j];
    float r_prim = fabsf(x - z), r_dual = fabsf(px + q + y);
    float r_x = fabsf(x), r_z = fabsf(z), r_px = fabsf(px), r_y = fabsf(y);
    if (SCALED) {
      // |d v| = d |v| and |v / d| = |v| / d, for d > 0
      r_prim *= d;
      r_x *= d;
      r_z *= d;
      r_dual /= d;
      r_px /= d;
      r_y /= d;
    }
    prim = T::max(r_prim);
    dual = T::max(r_dual);
    xmax = T::max(r_x);
    zmax = T::max(r_z);
    pxmax = T::max(r_px);
    ymax = T::max(r_y);
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

  if (store && live) {
    z_out[at] = SCALED ? d * z : z;
    y_out[at] = SCALED ? y / d : y;
  }
  if (store && r == 0) {
    const float aux[kAuxRows] = {prim, dual, xmax, zmax, pxmax, qmax, ymax, rho};
#pragma unroll
    for (int a = 0; a < kAuxRows; ++a) aux_out[(size_t)a * B + b] = aux[a];
  }
}

template <int N, bool SCALED>
cudaError_t launch(const float* P, const float* q, const float* lb, const float* ub,
                   const float* x0, const float* y0, const float* rho0, float* z, float* y,
                   float* aux, int B, int iters, int rounds, float rho_scale, float sigma,
                   float alpha, float eps_abs, float eps_rel, float acc_abs, float acc_rel,
                   cudaStream_t stream) {
  constexpr int teams = kThreads / team_width(N);
  const int blocks = (B + teams - 1) / teams;
  boxqp_small_kernel<N, SCALED><<<blocks, kThreads, 0, stream>>>(
      P, q, lb, ub, x0, y0, rho0, z, y, aux, B, iters, rounds, rho_scale, sigma, alpha,
      eps_abs, eps_rel, acc_abs, acc_rel);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mpc4q_boxqp_small(const float* P, const float* q, const float* lb,
                                 const float* ub, const float* x0, const float* y0,
                                 const float* rho0, float* z, float* y, float* aux, int B,
                                 int n, int iters, int rounds, int scaled, float rho_scale,
                                 float sigma, float alpha, float eps_abs, float eps_rel,
                                 float acc_abs, float acc_rel, void* stream) {
  if (B <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CASE(NN)                                                                       \
  case NN:                                                                             \
    return scaled ? launch<NN, true>(P, q, lb, ub, x0, y0, rho0, z, y, aux, B, iters,  \
                                     rounds, rho_scale, sigma, alpha, eps_abs, eps_rel, \
                                     acc_abs, acc_rel, s)                               \
                  : launch<NN, false>(P, q, lb, ub, x0, y0, rho0, z, y, aux, B, iters, \
                                      rounds, rho_scale, sigma, alpha, eps_abs, eps_rel, \
                                      acc_abs, acc_rel, s);
  switch (n) {
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef CASE
}
