// Relaxed-ADMM iterations of a batch of box QPs from a precomputed K^-1,
// any n >= 1: up to n = 239 with each thread's part of a K^-1 row in
// registers, above it streaming K^-1's rows from device memory (the
// streaming instance, at the end of this file).
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
// Work per lane, FMA = 2 flops: iters (2n^2 + 8n) flops against
// 4 (n^2 + 9n + 1) bytes; at not_state_freq's n = 50, 40 iterations,
// B = 1024, 221 MFLOP (3.3 us at 67 TFLOP/s) and 12.1 MB (3.6 us at 3.35 TB/s).
//
// Design. The first port kept K^-1 in shared memory and loaded two shared
// words for each FMA (the K^-1 entry and the rhs entry): the shared-load
// issue rate set its pace. Here thread (i, p) holds part p of row i of K^-1
// in registers, loaded once a launch, and reads the rhs vector from shared
// memory as float4 broadcasts: one shared load per 4 FMAs.
// - Register arrays need a compile-time length: the kernel is a template on
//   the column capacity C of a part and the parts S of a row. A row of n
//   columns splits into S parts of L = round4(ceil(n / S)) columns; part p
//   sums columns [p L, p L + L) and the S partial sums of a row combine by
//   __shfl_xor_sync. Instances: n <= 32 (C 32, S 1, a lane is one warp and
//   four lanes share a block, synchronised by __syncwarp), n <= 64 (64, 1),
//   n <= 128 (64, 2), n <= 160 (40, 4); no thread holds more than 64 row
//   registers.
// - Above n = 160 a whole K^-1 does not fit the register file next to the
//   threads' other registers (at n = 239 it alone is 228 KB of the SM's
//   256 KB): the (32, 4) instance keeps C = 32 columns of each part in
//   registers and the rest of the part, up to 28 columns, in shared memory,
//   laid out [column][thread] so neighbouring threads read neighbouring
//   words.
// - A warp lane (n <= 32) reads its K^-1 into shared memory in order and
//   takes its rows from there: a thread reading its own row from device
//   memory touches a new sector on every load, 32 sectors a warp-wide load.
//   With one lane a block (n > 32) the threads read their rows directly:
//   there the staged copy, which no other work of the block overlaps,
//   measured slower (PERF.md).
// - A whole row (S = 1) sums its columns in order 0..n-1, the order of the
//   Pallas column loop and of the first port. A split row sums each part in
//   column order and adds the parts pairwise, (p0 + p1) + (p2 + p3): another
//   rounding order, within float32 rounding of the plain version.
// - The rhs vector is double-buffered in shared memory with one barrier an
//   iteration. A part's columns start at p * PL, PL >= max(L, C) with
//   PL / 4 odd, so the S parts' float4 reads fall on distinct banks; each
//   thread sums all C register columns (those past L are zeros on both
//   sides), so the loop has no branch and its loads issue ahead of the
//   FMA chain.
// - No tensor cores: each lane has one right-hand side an iteration and the
//   iterations are serial, and wgmma would need TF32 or bf16 operands,
//   whose ~3 digits the ADMM's 1e-6 tolerances cannot take.
//
// The streaming instance, n >= 240. A lane's K^-1 no longer fits an SM (at
// n = 240 it is 230 KB against 256 KB of registers and 227 KB of shared
// memory), so one block of 1024 threads takes one lane and reads K^-1 from
// device memory every iteration, as the Pallas kernel's one-dispatch-a-
// lane-tile form does above 4 MB a block (pallas_qp.py:439-447). Warp w
// takes rows 4w..4w+3, then the next four of its stride: its 32 threads
// read the four rows in coalesced 128-byte pieces (up to 16 loads in
// flight a thread), multiply by the rhs vector, which lives in shared memory (2 n
// floats, double-buffered), and sum each row by a xor shuffle; thread j of
// the warp then updates z and y of row 4w + j elementwise, keeping x, z
// and y of the lane in the output arrays, and writes that row of the next
// rhs vector into the other buffer: one barrier an iteration. A row sums its
// columns in another order than the plain version (strided by 32, then a
// shuffle tree): float32 rounding, held to the same tolerance as the
// split-row instances. At B 128, n 240 the batch's K^-1 is 29.5 MB, inside
// the 50 MB L2, so the kernel is bound by L2 bandwidth and by the
// iterations' serial chain, not by its flops. Above n = 29,056 the two rhs
// buffers (8 n bytes) pass the 227 KB of shared memory; there they sit in a
// workspace in device memory that the wrapper allocates (B x 2 n floats),
// so no n is refused. Spreading a lane's K^-1 over a thread-block
// cluster's distributed shared memory, 2-4 SMs a lane, is the next step
// (ROADMAP queue 2).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 239;  // the largest n of the register instances
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kStreamThreads = 1024;
constexpr int kStreamRows = 4;  // rows a warp of the streaming instance sums at once
// the largest n whose two rhs buffers fit the 227 KB of shared memory a
// block may opt into
constexpr int kStreamSmemMaxN = 232448 / 8;
constexpr unsigned kFull = 0xffffffffu;

// NaN-propagating max, min and clip, matching jnp.maximum / jnp.minimum:
// fmaxf / fminf drop a NaN, and a NaN lane must never read as converged
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}

// the part length L of a row of n columns in S parts, and a part's stride
// in the rhs vector: room for all C register columns, m / 4 odd so S <= 4
// parts read distinct banks
__host__ __device__ __forceinline__ int part_len(int n, int S) {
  return ((n + S - 1) / S + 3) / 4 * 4;
}
__host__ __device__ __forceinline__ int part_stride(int L, int C) {
  const int m = L > C ? L : C;
  return (m / 4) % 2 ? m : m + 4;
}

// the floats of a lane's shared region: the two rhs buffers of `vec`
// floats, or the staged n x ld K^-1 where that is larger, rounded up to
// whole float4s so every lane's buffers stay 16-byte aligned
__host__ __device__ __forceinline__ int lane_region(int n, int ld, int vec, bool staged) {
  const int floats = staged && n * ld > 2 * vec ? n * ld : 2 * vec;
  return (floats + 3) / 4 * 4;
}

// the threads of a block of an instance at its largest n, NMAX
__host__ __device__ constexpr int max_threads(int S, int LANES, int NMAX) {
  return LANES > 1 ? 32 * LANES : (NMAX * S + 31) / 32 * 32;
}

template <int C, int S, int LANES, bool TAIL, int NMAX>
__global__ void __launch_bounds__(max_threads(S, LANES, NMAX))
admm_big_kernel(const float* __restrict__ kinv, const float* __restrict__ q_in,
                const float* __restrict__ lb_in, const float* __restrict__ ub_in,
                const float* __restrict__ rho_in, const float* __restrict__ x_in,
                const float* __restrict__ z_in, const float* __restrict__ y_in,
                float* __restrict__ x_out, float* __restrict__ z_out,
                float* __restrict__ y_out, int B, int n, int iters, float sigma,
                float alpha) {
  extern __shared__ __align__(16) float smem[];
  const int L = part_len(n, S), PL = part_stride(L, C);
  const int tail = TAIL ? L - C : 0;      // columns of a part past the registers
  const int T = blockDim.x / LANES;       // threads of a lane
  const int slot = threadIdx.x / T;
  const int t = threadIdx.x - slot * T;
  const size_t lane = (size_t)blockIdx.x * LANES + slot;
  if (LANES > 1 && lane >= (size_t)B) return;  // whole warps: no block barrier in this form
  auto sync = [] {
    if constexpr (LANES > 1) __syncwarp(); else __syncthreads();
  };
  // a lane's region: first the staged K^-1 (warp lanes), then the two rhs
  // buffers of S * PL; the TAIL form's columns after all lanes
  const int ld = n | 1;
  const int region = lane_region(n, ld, S * PL, LANES > 1);
  float* rhs = smem + slot * region;
  float* tailk = smem + LANES * region;  // tailk[c * T + t]

  const int i = t / S, p = t % S;
  const bool own = i < n;  // threads past the last row hold zeros and keep the barriers
  const int col0 = p * L;
  const float* klane = kinv + lane * n * n;
  float kr[C];
  if constexpr (LANES == 1) {
    // each thread reads its row part from device memory
    const float* krow = klane + (size_t)(own ? i : 0) * n;
#pragma unroll
    for (int k = 0; k < C; ++k) kr[k] = (own && k < L && col0 + k < n) ? __ldg(krow + col0 + k) : 0.0f;
    if (TAIL) {
      for (int c = 0; c < tail; ++c) {
        const int col = col0 + C + c;
        tailk[c * T + t] = (own && col < n) ? __ldg(krow + col) : 0.0f;
      }
    }
  } else {
    // a warp lane stages its K^-1 through shared memory: coalesced reads of
    // the n x n block, then each thread takes its row from rows of odd
    // stride ld (no bank conflicts); the stage is the rhs buffers' space
    float* stage = rhs;
#pragma unroll 8
    for (int e = t; e < n * n; e += T) {
      const int r = e / n;
      stage[r * ld + e - r * n] = __ldg(klane + e);
    }
    sync();
    const float* srow = stage + (own ? i : 0) * ld + col0;
#pragma unroll
    for (int k = 0; k < C; ++k) kr[k] = (own && k < L && col0 + k < n) ? srow[k] : 0.0f;
    sync();
  }
  for (int e = t; e < 2 * S * PL; e += T) rhs[e] = 0.0f;
  const int pos = (i / L) * PL + i % L;  // row i's entry in the rhs vector
  const size_t at = lane * n + (own ? i : 0);
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
  sync();

  for (int it = 0; it < iters; ++it) {
    float* v = rhs + (it & 1) * S * PL;
    if (own && p == 0) v[pos] = sigma * x - q + rho * z - y;
    sync();
    const float* vp = v + p * PL;
    const float4* v4 = reinterpret_cast<const float4*>(vp);
    // all C columns, those past the part's L zeros in kr and in v: no
    // branch between the loads, so they issue ahead of the FMA chain
    float acc = 0.0f;
#pragma unroll
    for (int k4 = 0; k4 < C / 4; ++k4) {
      const float4 r = v4[k4];
      if (k4 == 0) acc = kr[0] * r.x; else acc += kr[4 * k4] * r.x;
      acc += kr[4 * k4 + 1] * r.y;
      acc += kr[4 * k4 + 2] * r.z;
      acc += kr[4 * k4 + 3] * r.w;
    }
    if (TAIL) {
      for (int c = 0; c < tail; ++c) acc += tailk[c * T + t] * vp[C + c];
    }
#pragma unroll
    for (int m = 1; m < S; m <<= 1) acc += __shfl_xor_sync(kFull, acc, m);
    x = acc;
    const float z_arg = alpha * x + one_m_alpha * z;
    const float z_new = nan_min(nan_max(z_arg + y / rho, lb), ub);
    y = y + rho * (z_arg - z_new);
    z = z_new;
  }

  if (own && p == 0) {
    x_out[at] = x;
    z_out[at] = z;
    y_out[at] = y;
  }
}

// dynamic shared memory of an instance at size n, and its threads a lane
template <int C, int S, int LANES, bool TAIL>
size_t smem_bytes(int n, int* threads) {
  const int L = part_len(n, S), PL = part_stride(L, C);
  const int T = LANES > 1 ? 32 : (n * S + 31) / 32 * 32;
  if (threads) *threads = T;
  const int tail = TAIL ? L - C : 0;
  return sizeof(float) *
         ((size_t)LANES * lane_region(n, n | 1, S * PL, LANES > 1) + (size_t)tail * T);
}

template <int C, int S, int LANES, bool TAIL, int NMAX>
cudaError_t launch(const float* kinv, const float* q, const float* lb, const float* ub,
                   const float* rho, const float* x, const float* z, const float* y,
                   float* x_out, float* z_out, float* y_out, int B, int n, int iters,
                   float sigma, float alpha, cudaStream_t stream) {
  int T = 0;
  const size_t smem = smem_bytes<C, S, LANES, TAIL>(n, &T);
  auto kernel = admm_big_kernel<C, S, LANES, TAIL, NMAX>;
  // above 48 KB dynamic shared memory must be opted into: once an instance,
  // for its largest n (the need grows with n), so a launch makes no other
  // API call and can be captured in a CUDA graph
  static const size_t smem_max = smem_bytes<C, S, LANES, TAIL>(NMAX, nullptr);
  static const cudaError_t attr =
      smem_max > kDefaultSmem
          ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_max)
          : cudaSuccess;
  if (attr != cudaSuccess) return attr;
  if (smem > smem_max) return cudaErrorInvalidValue;
  kernel<<<(B + LANES - 1) / LANES, T * LANES, smem, stream>>>(
      kinv, q, lb, ub, rho, x, z, y, x_out, z_out, y_out, B, n, iters, sigma, alpha);
  return cudaGetLastError();
}

// the streaming instance: rhs in shared memory (SMEM), or in the lane's
// slice of the workspace ws (B x 2n floats)
template <bool SMEM>
__global__ void __launch_bounds__(kStreamThreads)
admm_stream_kernel(const float* __restrict__ kinv, const float* __restrict__ q_in,
                   const float* __restrict__ lb_in, const float* __restrict__ ub_in,
                   const float* __restrict__ rho_in, const float* __restrict__ x_in,
                   const float* __restrict__ z_in, const float* __restrict__ y_in,
                   float* __restrict__ x_out, float* __restrict__ z_out,
                   float* __restrict__ y_out, float* ws, int n, int iters, float sigma,
                   float alpha) {
  extern __shared__ __align__(16) float smem[];
  const size_t lane = blockIdx.x;
  float* rhs = SMEM ? smem : ws + lane * 2 * n;
  const float* klane = kinv + lane * n * n;
  const size_t base = lane * n;
  const float* q = q_in + base;
  const float* lb = lb_in + base;
  const float* ub = ub_in + base;
  float* x = x_out + base;
  float* z = z_out + base;
  float* y = y_out + base;
  const float rho = __ldg(rho_in + lane);
  const float one_m_alpha = 1.0f - alpha;
  // the lane's iterates go to the outputs, where the updates keep them, and
  // the first rhs vector to buffer 0
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float xi = __ldg(x_in + base + i), zi = __ldg(z_in + base + i),
                yi = __ldg(y_in + base + i);
    x[i] = xi;
    z[i] = zi;
    y[i] = yi;
    rhs[i] = sigma * xi - __ldg(q + i) + rho * zi - yi;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, t = threadIdx.x % 32, warps = blockDim.x / 32;
  for (int it = 0; it < iters; ++it) {
    const float* v = rhs + (it & 1) * n;
    float* v_next = rhs + ((it + 1) & 1) * n;
    // kStreamRows rows a warp at a time and the column loop unrolled by 4,
    // so each thread has up to 16 loads in flight; after the shuffle sums
    // thread j updates row r0 + j
    for (int r0 = warp * kStreamRows; r0 < n; r0 += warps * kStreamRows) {
      const int rows = n - r0 < kStreamRows ? n - r0 : kStreamRows;
      const float* krow = klane + (size_t)r0 * n;
      float acc[kStreamRows];
#pragma unroll
      for (int j = 0; j < kStreamRows; ++j) acc[j] = 0.0f;
#pragma unroll 4
      for (int c = t; c < n; c += 32) {
        const float vc = v[c];
#pragma unroll
        for (int j = 0; j < kStreamRows; ++j)
          if (j < rows) acc[j] = fmaf(__ldg(krow + (size_t)j * n + c), vc, acc[j]);
      }
      float mine = 0.0f;
#pragma unroll
      for (int j = 0; j < kStreamRows; ++j) {
        for (int m = 16; m > 0; m >>= 1) acc[j] += __shfl_xor_sync(kFull, acc[j], m);
        if (t == j) mine = acc[j];
      }
      if (t < rows) {
        const int r = r0 + t;
        const float zr = z[r], yr = y[r];
        const float z_arg = alpha * mine + one_m_alpha * zr;
        const float z_new = nan_min(nan_max(z_arg + yr / rho, __ldg(lb + r)), __ldg(ub + r));
        const float y_new = yr + rho * (z_arg - z_new);
        x[r] = mine;
        z[r] = z_new;
        y[r] = y_new;
        v_next[r] = sigma * mine - __ldg(q + r) + rho * z_new - y_new;
      }
    }
    __syncthreads();
  }
}

cudaError_t launch_stream(const float* kinv, const float* q, const float* lb, const float* ub,
                          const float* rho, const float* x, const float* z, const float* y,
                          float* x_out, float* z_out, float* y_out, float* ws, int B, int n,
                          int iters, float sigma, float alpha, cudaStream_t stream) {
  if (n <= kStreamSmemMaxN) {
    // opted into once, at the largest n, so a launch makes no other API call
    static const cudaError_t attr = cudaFuncSetAttribute(
        admm_stream_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(2 * sizeof(float) * kStreamSmemMaxN));
    if (attr != cudaSuccess) return attr;
    admm_stream_kernel<true><<<B, kStreamThreads, 2 * sizeof(float) * n, stream>>>(
        kinv, q, lb, ub, rho, x, z, y, x_out, z_out, y_out, nullptr, n, iters, sigma, alpha);
  } else {
    if (ws == nullptr) return cudaErrorInvalidValue;
    admm_stream_kernel<false><<<B, kStreamThreads, 0, stream>>>(
        kinv, q, lb, ub, rho, x, z, y, x_out, z_out, y_out, ws, n, iters, sigma, alpha);
  }
  return cudaGetLastError();
}

}  // namespace

// ws: null, or above n = kStreamSmemMaxN a workspace of B x 2n floats
extern "C" int mpc4q_admm_big(const float* kinv, const float* q, const float* lb,
                              const float* ub, const float* rho, const float* x,
                              const float* z, const float* y, float* x_out, float* z_out,
                              float* y_out, float* ws, int B, int n, int iters, float sigma,
                              float alpha, void* stream) {
  if (n < 1 || iters < 0) return cudaErrorInvalidValue;
  if (B <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > kMaxN)
    return launch_stream(kinv, q, lb, ub, rho, x, z, y, x_out, z_out, y_out, ws, B, n, iters,
                         sigma, alpha, s);
#define ARGS kinv, q, lb, ub, rho, x, z, y, x_out, z_out, y_out, B, n, iters, sigma, alpha, s
  if (n <= 32) return launch<32, 1, 4, false, 32>(ARGS);
  if (n <= 64) return launch<64, 1, 1, false, 64>(ARGS);
  if (n <= 128) return launch<64, 2, 1, false, 128>(ARGS);
  if (n <= 160) return launch<40, 4, 1, false, 160>(ARGS);
  return launch<32, 4, 1, true, kMaxN>(ARGS);
#undef ARGS
}
