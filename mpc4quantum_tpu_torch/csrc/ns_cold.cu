// The cold Newton-Schulz K^-1 of the large-n box QP: one CTA a lane runs
// the whole chain of solvers/boxqp.py::_ns_inverse(K, iters) with no X0,
//   X_0 = K^T / (||K||_1 ||K||_inf),
//   X_{t+1} = X_t + X_t (I - K X_t)          t < iters - 1, float32,
//   X_iters = X + X R, R = I - K X accumulated in float64 from the float32
//             K and X and rounded to float32,
// on 17 <= n <= 152, in float32 FFMA (no TF32, no tensor cores) and DFMA.
// X_t (2I - K X_t) of the plain chain is the same step in exact arithmetic.
//
// Replaces no Pallas kernel: the JAX package leaves this chain to XLA's
// matmuls (mpc4quantum_tpu/solvers/boxqp.py::ns_inverse). It was added
// because the port's plain chain is 2 iters batched GEMMs (and their
// elementwise ops) whose 32 x 32 tiles read K and X from device memory for
// every product; at cnot_state's B 1,024, n 150, 20 steps that is 14.3 ms a
// chain at a third of the card's float32 rate.
//
// Bound, B 1,024, n 150, 20 steps (FMA = 2 flops): the chain's 40 products
// are 276 GFLOP, 4.1 ms at 67 TFLOP/s (4.2 with the last step's float64
// product at 34 TFLOP/s). Bytes: K read and X written once, 184 MB, 55 us at
// 3.35 TB/s. So the chain is bound by the FMA rate, and the design keeps
// every operand of every product in shared memory.
//
// Both products in full. Every iterate of the cold chain is a polynomial in
// K, so in exact arithmetic K X and X (I - K X) are symmetric and one
// triangle of each would do (2.1 ms). In float32 neither triangle holds: a
// mirror of that arithmetic in PyTorch, with K X's upper triangle mirrored,
// ends cnot_state's first QPs at ||I - K X||_inf 4.5e-2 against the plain
// chain's 3.0e-6; with only X (I - K X) mirrored, random SPD K at condition
// 4e3-8e4 run from 8x the plain residual at 30 steps to 7e4 at 40 and NaN
// at 60. The rounding that does not commute with K is what the full
// product damps and the mirror does not. In full, the same mirror stays
// within 0.6x of twice the plain residual.
//
// Design. One CTA a lane, 32-256 threads by n (geometry below).
//   - Shared memory: X (row-major) and X^T, rows of W >= n floats, zero
//     past n; E = I - K X replaces X once every thread has read it. At n
//     150, 2 x 152 x 156 x 4 B = 190 KB; with the ring, 210 KB, so one lane
//     an SM.
//   - K streams through a ring of 4 stages of 8 of its columns, stored as
//     rows (ring[r][i] = K[i][8 c + r]), fed by 4-byte cp.async (a row of K
//     need not be 16-byte aligned) three chunks ahead of the product; the
//     132 lanes in flight hold 12 MB of K, which stays in the 50 MB L2
//     across their 20 steps.
//   - Both products are outer products over k: K X takes K's column k from
//     the ring and X's row k; X E takes X's column k as X^T's row k and E's
//     row k. Thread (ti, tj) owns rows 8 ti .. 8 ti + 7 and three 4-column
//     chunks of stride 4 ct, rotated by ti (Tile): 96 float32 accumulators;
//     per k two float4 of the A side and three of the B side feed 96 FFMA.
//     At n 150, 247 tiles on 256 threads, 2 warps a scheduler.
//   - X + X E: the tile of X E is stored in E's place, then each 4 x 4
//     block of X is read from X^T's rows, added, and written to X and X^T
//     as float4, so the transposed copy costs no scattered stores.
//   - The last step's K X in three passes over the column chunks, 32
//     double accumulators a thread, its E held in registers until every
//     pass has read X.
//   - Sums run over k in order: no atomics, so a replay equals the call bit
//     for bit.
// Measured (H100 at 700 W, B 1,024, n 150, 20 steps): 8.3 ms a chain, 50% of
// the float32 rate, against the plain chain's 14.4 ms. Probes of the design
// put the FFMA loop at ~70% of its issue rate (its shared-memory loads cost
// ~7% of it), the ring's cp.async and barriers at ~15% of a step before its
// copy took a fixed column a thread (8.59 -> 8.27 ms), the 4 x 4 write-back
// at ~5%, and the float64 last step at 1.25 float32 steps.
// ||K||_1 and ||K||_inf are the largest column and row sums of |K|, read
// from K staged in shared memory; a NaN anywhere gives NaN norms, as
// torch's amax does.

#include <cuda_runtime.h>

namespace {

constexpr int kMinN = 17;
constexpr int kMaxN = 152;
constexpr int kChunk = 8;       // columns of K a ring stage holds (one k-chunk)
constexpr int kStages = 4;      // ring stages
constexpr int kRows = 8;        // rows of a thread's tile
constexpr int kThreadsMax = 256;
constexpr int kMaxSmem = 232448;  // the opt-in maximum a block of sm_90
constexpr int kScratch = 2 * kThreadsMax / 32;  // the norms' per-warp maxima

// the shapes of a lane's work at size n
struct Geometry {
  int m;        // row tiles: kRows m >= n
  int ct;       // 12-column tiles
  int w;        // row stride of X, E and X^T (floats), 12 ct >= kRows m
  int chunks;   // k-chunks of kChunk: kp = kChunk chunks >= n
  int kp;       // rows of the buffers (zero past n)
  int rs;       // row stride of a ring row, >= w, rs / 4 odd (conflict-free stores)
  int tasks;    // tiles of a product: m ct
  int threads;
  size_t smem;  // bytes
};

__host__ __device__ inline Geometry geometry(int n) {
  Geometry g;
  g.m = (n + kRows - 1) / kRows;
  g.ct = (kRows * g.m + 11) / 12;
  g.w = 12 * g.ct;
  g.chunks = (n + kChunk - 1) / kChunk;
  g.kp = kChunk * g.chunks;
  g.rs = (g.w / 4) % 2 ? g.w : g.w + 4;
  g.tasks = g.m * g.ct;
  g.threads = (g.tasks + 31) / 32 * 32;
  g.smem = sizeof(float) * (size_t)(2 * g.kp * g.w + kStages * kChunk * g.rs + kScratch);
  return g;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float fma_acc(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_acc(double a, double b, double c) { return ::fma(a, b, c); }

// NaN-propagating max, as torch's amax
__device__ __forceinline__ float nan_max(float a, float b) { return (a != a || a > b) ? a : b; }

// the thread's tile of a product: rows kRows ti .. kRows ti + kRows - 1 and
// three 4-column chunks; slot q holds columns 4 tj + boff[q] + (0..3),
// boff[q] = 4 ct ((q + ti) % 3): rotated by the row of tiles, so that the 8
// threads of a quarter-warp that straddle two rows of tiles read a row of X
// or E at 8 consecutive float4 (distinct banks) more often
struct Tile {
  int ti, tj;
  int boff[3];
  bool active;
};

// Queue chunk c of K (columns kChunk c ..) into its ring stage as rows:
// ring[r][i] = K[i][kChunk c + r]; columns past n are stored as zeros. Thread
// t copies column r = t % kChunk at rows t / kChunk + (blockDim / kChunk) u, so
// a warp reads 32-byte runs of 4 rows and writes 32 distinct banks. One
// commit group a call, empty past the last chunk.
__device__ __forceinline__ void issue_chunk(float* ring, const float* __restrict__ Kb,
                                            const Geometry& g, int n, int c) {
  if (c < g.chunks) {
    const int r = threadIdx.x % kChunk, col = c * kChunk + r;
    const int i0 = threadIdx.x / kChunk, step = blockDim.x / kChunk;
    float* dst = ring + (c % kStages) * kChunk * g.rs + r * g.rs;
    if (col < n) {
      const float* src = Kb + (size_t)i0 * n + col;
      const size_t dsrc = (size_t)step * n;
      for (int i = i0; i < n; i += step, src += dsrc) cp_async4(dst + i, src);
    } else {
      for (int i = i0; i < n; i += step) dst[i] = 0.f;
    }
  }
  cp_async_commit();
}

// acc[r][4 q + c] += sum over kChunk k of a[k][r] b[k][boff[Q0 + q] + c]:
// a's row k at a + k as (kRows floats), b's at b + k bs
template <typename Acc, int NQ, int Q0>
__device__ __forceinline__ void accumulate(Acc (&acc)[kRows][4 * NQ], const float* a, int as,
                                           const float* b, int bs, const int (&boff)[3]) {
#pragma unroll
  for (int kk = 0; kk < kChunk; ++kk) {
    float av[kRows];
#pragma unroll
    for (int r4 = 0; r4 < kRows / 4; ++r4) {
      const float4 v = ld4(a + kk * as + 4 * r4);
      av[4 * r4] = v.x;
      av[4 * r4 + 1] = v.y;
      av[4 * r4 + 2] = v.z;
      av[4 * r4 + 3] = v.w;
    }
    float bv[4 * NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float4 v = ld4(b + kk * bs + boff[Q0 + q]);
      bv[4 * q] = v.x;
      bv[4 * q + 1] = v.y;
      bv[4 * q + 2] = v.z;
      bv[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int c = 0; c < 4 * NQ; ++c)
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r][c] = fma_acc(Acc(av[r]), Acc(bv[c]), acc[r][c]);
  }
}

// e = I - K X on the tile's column chunks Q0 .. Q0 + NQ - 1 (0 outside
// n x n), accumulated in Acc: K streams through the ring as columns, X's
// rows are read from shared memory
template <typename Acc, int NQ, int Q0>
__device__ __forceinline__ void residual_pass(const float* __restrict__ Kb, const float* X,
                                              float* ring, const Geometry& g, int n,
                                              const Tile& tl, float (&e)[kRows][12]) {
  Acc acc[kRows][4 * NQ];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < 4 * NQ; ++c) acc[r][c] = Acc(0);
  __syncthreads();  // the ring's readers of the previous pass are done
#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) issue_chunk(ring, Kb, g, n, s);
#pragma unroll 1
  for (int c = 0; c < g.chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c is in; every thread is past chunk c - 1
    issue_chunk(ring, Kb, g, n, c + kStages - 1);
    if (tl.active) {
      accumulate<Acc, NQ, Q0>(acc, ring + (c % kStages) * kChunk * g.rs + kRows * tl.ti, g.rs,
                              X + c * kChunk * g.w + 4 * tl.tj, g.w, tl.boff);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = kRows * tl.ti + r;
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4) {
        const int j = 4 * tl.tj + tl.boff[Q0 + q] + c4;
        const Acc v = Acc(i == j ? 1 : 0) - acc[r][4 * q + c4];
        e[r][4 * (Q0 + q) + c4] = (i < n && j < n) ? static_cast<float>(v) : 0.f;
      }
  }
}

// the tile v (slot q at columns 4 tj + boff[q]) into M, a float4 a row and slot
__device__ __forceinline__ void store_tile(float* M, const float (&v)[kRows][12], const Tile& tl,
                                           const Geometry& g) {
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int q = 0; q < 3; ++q)
      *reinterpret_cast<float4*>(M + (kRows * tl.ti + r) * g.w + 4 * tl.tj + tl.boff[q]) =
          make_float4(v[r][4 * q], v[r][4 * q + 1], v[r][4 * q + 2], v[r][4 * q + 3]);
}

// X <- X + D, where X holds D = X E and X^T the old X: by 4 x 4 blocks, the
// old block read from X^T's rows and turned in registers, the new one
// written to both. Thread blk takes the block (s, (s + d) % nb) of diagonal
// d = blk / nb, s = blk % nb, so the 8 threads of a quarter-warp read and
// write 8 distinct banks in both layouts
__device__ __forceinline__ void add_and_transpose(float* X, float* Xt, const Geometry& g) {
  const int nb = kRows * g.m / 4;
  for (int blk = threadIdx.x; blk < nb * nb; blk += blockDim.x) {
    const int bi = blk % nb, bj = (bi + blk / nb) % nb;
    float v[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 d = ld4(X + (4 * bi + r) * g.w + 4 * bj);
      v[r][0] = d.x;
      v[r][1] = d.y;
      v[r][2] = d.z;
      v[r][3] = d.w;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 o = ld4(Xt + (4 * bj + c) * g.w + 4 * bi);  // X[4 bi + r][4 bj + c]
      v[0][c] += o.x;
      v[1][c] += o.y;
      v[2][c] += o.z;
      v[3][c] += o.w;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<float4*>(X + (4 * bi + r) * g.w + 4 * bj) =
          make_float4(v[r][0], v[r][1], v[r][2], v[r][3]);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(Xt + (4 * bj + c) * g.w + 4 * bi) =
          make_float4(v[0][c], v[1][c], v[2][c], v[3][c]);
  }
}

__global__ void __launch_bounds__(kThreadsMax)
    ns_cold_kernel(const float* __restrict__ K, float* __restrict__ out, int n, int iters) {
  extern __shared__ float4 smem4[];
  const Geometry g = geometry(n);
  float* X = reinterpret_cast<float*>(smem4);  // X, row-major; E = I - K X in its place
  float* Xt = X + g.kp * g.w;                  // X^T
  float* ring = Xt + g.kp * g.w;
  float* scratch = ring + kStages * kChunk * g.rs;
  const float* Kb = K + (size_t)blockIdx.x * n * n;
  float* ob = out + (size_t)blockIdx.x * n * n;
  const int t = threadIdx.x, nt = blockDim.x;
  Tile tl;
  tl.active = t < g.tasks;
  tl.ti = tl.active ? t / g.ct : 0;
  tl.tj = tl.active ? t % g.ct : 0;
#pragma unroll
  for (int q = 0; q < 3; ++q) tl.boff[q] = 4 * g.ct * ((q + tl.ti) % 3);

  // the buffers start at zero: their padding stays zero throughout
  for (int i = t; i < 2 * g.kp * g.w + kStages * kChunk * g.rs; i += nt) X[i] = 0.f;
  __syncthreads();
  for (int idx = t; idx < n * n; idx += nt) Xt[(idx / n) * g.w + idx % n] = Kb[idx];
  __syncthreads();
  // ||K||_inf, the largest row sum of |K|, and ||K||_1, the largest column sum
  float rmax = 0.f, cmax = 0.f;
  for (int i = t; i < n; i += nt) {
    float rs = 0.f, cs = 0.f;
    for (int j = 0; j < n; ++j) {
      rs += fabsf(Xt[i * g.w + j]);
      cs += fabsf(Xt[j * g.w + i]);
    }
    rmax = nan_max(rs, rmax);
    cmax = nan_max(cs, cmax);
  }
  for (int off = 16; off > 0; off >>= 1) {
    rmax = nan_max(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
    cmax = nan_max(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
  }
  const int warps = nt / 32;
  if (t % 32 == 0) {
    scratch[t / 32] = rmax;
    scratch[warps + t / 32] = cmax;
  }
  __syncthreads();
  float ninf = scratch[0], n1 = scratch[warps];
  for (int wi = 1; wi < warps; ++wi) {
    ninf = nan_max(scratch[wi], ninf);
    n1 = nan_max(scratch[warps + wi], n1);
  }
  // X_0 = K^T / s and its transpose K / s
  const float s = n1 * ninf;
  for (int idx = t; idx < n * n; idx += nt) {
    const int i = idx / n, j = idx % n;
    X[i * g.w + j] = Xt[j * g.w + i] / s;
  }
  __syncthreads();
  for (int idx = t; idx < n * n; idx += nt) {
    const int i = idx / n, j = idx % n;
    Xt[i * g.w + j] /= s;
  }

  for (int it = 0; it < iters; ++it) {
    float e[kRows][12];
    if (it + 1 < iters) {
      residual_pass<float, 3, 0>(Kb, X, ring, g, n, tl, e);
    } else {
      residual_pass<double, 1, 0>(Kb, X, ring, g, n, tl, e);
      residual_pass<double, 1, 1>(Kb, X, ring, g, n, tl, e);
      residual_pass<double, 1, 2>(Kb, X, ring, g, n, tl, e);
    }
    __syncthreads();  // every thread is done reading X
    if (tl.active) store_tile(X, e, tl, g);
    __syncthreads();
    // X E: X's columns are the rows of X^T
    float acc[kRows][12];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < 12; ++c) acc[r][c] = 0.f;
    if (tl.active) {
#pragma unroll 1
      for (int k0 = 0; k0 < g.kp; k0 += kChunk) {
        accumulate<float, 3, 0>(acc, Xt + k0 * g.w + kRows * tl.ti, g.w,
                                X + k0 * g.w + 4 * tl.tj, g.w, tl.boff);
      }
    }
    __syncthreads();  // every thread is done reading E and X^T
    if (tl.active) store_tile(X, acc, tl, g);
    __syncthreads();
    add_and_transpose(X, Xt, g);
  }
  __syncthreads();
  for (int idx = t; idx < n * n; idx += nt) ob[idx] = X[(idx / n) * g.w + idx % n];
}

}  // namespace

// K (B, n, n) float32 row-major, out (B, n, n): out[b] = the chain of
// K[b], `iters` steps. Refuses n outside [17, 152], B < 1 or iters < 0.
extern "C" int mpc4q_ns_cold(const float* K, float* out, int B, int n, int iters, void* stream) {
  if (B < 1 || n < kMinN || n > kMaxN || iters < 0) return cudaErrorInvalidValue;
  const Geometry g = geometry(n);
  if (g.smem > (size_t)kMaxSmem || g.threads > kThreadsMax) return cudaErrorInvalidValue;
  // opted into once, at the most a block may take, so a launch makes no
  // other API call and can be captured in a CUDA graph
  static const cudaError_t attr = cudaFuncSetAttribute(
      ns_cold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  ns_cold_kernel<<<B, g.threads, g.smem, static_cast<cudaStream_t>(stream)>>>(K, out, n, iters);
  return cudaGetLastError();
}
