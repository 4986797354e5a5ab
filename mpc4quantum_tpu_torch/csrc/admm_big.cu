// Relaxed-ADMM iterations of a batch of box QPs from a precomputed K^-1,
// any n >= 1: up to n = 239 one block a lane with each thread's part of a
// K^-1 row in registers; at n 240-736 one thread-block cluster a lane,
// K^-1 spread over the cluster's registers and shared memory (the cluster
// instance); above it streaming K^-1's rows from device memory (the
// streaming instance). The last two are at the end of this file.
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
// The cluster instance, n = 240-736 (kClusterMaxN). A lane's K^-1 no
// longer fits one SM (at n = 240 it is 230 KB against 256 KB of registers
// and 227 KB of shared memory), so a cluster of c CTAs takes one lane and
// CTA k holds rows [k R, k R + R) of it, R = ceil(n / c), for the whole
// launch: K^-1 is read from device memory once a launch, as the work count
// (kernels/admm_big.py::admm_big_work) charges it. Thread (g, p) holds two
// rows (kClusterRows) of part p of S = 4 parts of L = round4(ceil(n / 4))
// columns: C = 40 columns of each in registers (80 registers of K^-1, 128
// in all, no spill) and the other L - 40 in shared memory as float4s laid
// out [row][column / 4][thread], so neighbouring threads read neighbouring
// 16 bytes; each row's q, lb and ub sit in shared memory too, by thread,
// to leave the registers to K^-1. Each rhs float4, read from the CTA's own
// copy of the vector (double-buffered, parts at bank-distinct strides as in
// the register instances), serves both rows. A row part's columns go in
// order into two sums (even and odd columns: half the chain of dependent
// FMAs), then the four parts by xor shuffles (all four threads get the
// same sum); y / rho is y (1 / rho), the reciprocal taken once a lane.
// The exchange: each row's entry of the next rhs vector goes to every CTA
// by st.async (thread p of a row the CTAs p, p + 4, ...), completing 4
// bytes on that CTA's mbarrier of the buffer; each CTA waits for its whole
// vector (4 n bytes, posted by its thread 0) on its own mbarrier. A
// __syncthreads() between a CTA's reads of the current buffer and its
// stores into the next one keeps the buffers safe: a CTA stores into
// another's buffer only after it has that CTA's whole previous vector,
// which that CTA sends only after its own reads. No cluster-wide barrier in
// the loop: perf_cluster.py measured cluster.sync() with the remote stores
// at 0.69-0.72 us an iteration and st.async at 0.18-0.21 us on an H100.
// cluster.sync() comes once after every CTA has started and set up its
// barriers, before any remote store, and once at the end, before any CTA
// exits. c (cluster_plan) is the least in 2..8 whose CTA fits 512 threads
// and 227 KB: at n 240 c = 2, a CTA 256 threads and 48 KB, so two CTAs
// share an SM and B 128 runs its 256 CTAs in one wave on 132 SMs (the card
// holds 132 such clusters at once); n 241-416 c = 2, n 512 c = 4, n 673-736
// c = 8 (at n 737 a CTA of 8 would need 233 KB). The rounding order
// differs from the plain version's: float32 rounding, held to ADMM_TOL.
// What bounds it: each iteration's serial chain (the dot products' FMA
// chains, the shuffles, the clip, the exchange), about 1.3 us an iteration
// at B 128 n 240 against 0.22 us of float32 arithmetic.
//
// The streaming instance, n > 736. One block of 1024 threads takes one lane
// and reads K^-1 from device memory every iteration, as the Pallas kernel's
// one-dispatch-a-lane-tile form does above 4 MB a block
// (pallas_qp.py:439-447). Warp w takes rows 4w..4w+3, then the next four of
// its stride: its 32 threads read the four rows in coalesced 128-byte pieces
// (up to 16 loads in flight a thread), multiply by the rhs vector, which
// lives in shared memory (2 n floats, double-buffered), and sum each row by
// a xor shuffle; thread j of the warp then updates z and y of row 4w + j
// elementwise, keeping x, z and y of the lane in the output arrays, and
// writes that row of the next rhs vector into the other buffer: one barrier
// an iteration. A row sums its columns in another order than the plain
// version (strided by 32, then a shuffle tree). It is bound by the bandwidth
// of L2 or device memory (one SM a lane). Above n = 29,056 the two rhs
// buffers (8 n bytes) pass the 227 KB of shared memory; there they sit in a
// workspace in device memory that the wrapper allocates (B x 2 n floats),
// so no n is refused.
//
// mpc4q_admm_big_plan returns the instance, cluster size, threads and
// shared bytes of a call (kernels/admm_big.py::admm_big_plan computes the
// same), and with `query` the clusters the card can hold at once.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxN = 239;  // the largest n of the register instances
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kStreamThreads = 1024;
constexpr int kStreamRows = 4;  // rows a warp of the streaming instance sums at once
// the largest n whose two rhs buffers fit the 227 KB of shared memory a
// block may opt into
constexpr int kStreamSmemMaxN = 232448 / 8;
constexpr unsigned kFull = 0xffffffffu;
// the cluster instance: register columns and parts of a row, the portable
// cluster size, threads and shared memory a CTA may have, its largest n
constexpr int kClusterC = 40;
constexpr int kClusterS = 4;
constexpr int kClusterRows = 2;  // rows a thread
constexpr int kMaxCluster = 8;
constexpr int kClusterMaxThreads = 512;
constexpr int kMaxSmem = 232448;
constexpr int kClusterMaxN = 736;

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
__host__ __device__ constexpr int part_len(int n, int S) {
  return ((n + S - 1) / S + 3) / 4 * 4;
}
__host__ __device__ constexpr int part_stride(int L, int C) {
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

// a cluster instance launch: cluster size, threads and shared bytes a CTA
// (c = 0 where no cluster of kMaxCluster or fewer CTAs holds the lane)
struct ClusterPlan {
  int c, threads, smem;
};

__host__ __device__ constexpr int cluster_rows(int n, int c) { return (n + c - 1) / c; }

// the least c in 2..kMaxCluster whose CTA fits: R = ceil(n / c) rows,
// kClusterRows rows of one of S parts a thread, the parts' columns past C
// as float4s in shared memory next to the two rhs buffers, and each row's
// q, lb and ub
__host__ __device__ constexpr ClusterPlan cluster_plan(int n) {
  const int L = part_len(n, kClusterS), PL = part_stride(L, kClusterC);
  for (int c = 2; c <= kMaxCluster; ++c) {
    const int groups = (cluster_rows(n, c) + kClusterRows - 1) / kClusterRows;
    const int T = (groups * kClusterS + 31) / 32 * 32;
    const int smem =
        16 + 4 * (T * kClusterRows * (L - kClusterC + 3) + 2 * kClusterS * PL);
    if (T <= kClusterMaxThreads && smem <= kMaxSmem) return {c, T, smem};
  }
  return {0, 0, 0};
}
static_assert(cluster_plan(kMaxN + 1).c == 2, "the cluster instance starts at n = 240");
static_assert(cluster_plan(kClusterMaxN).c == kMaxCluster, "the cluster instance's largest n");
static_assert(cluster_plan(kClusterMaxN + 1).c == 0, "the cluster instance's largest n");

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

// the shared-window address of a pointer into this CTA's shared memory
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one float into CTA dst's shared memory at this CTA's address `slot`,
// completing 4 bytes of the transaction on CTA dst's mbarrier at this
// CTA's address `bar` (st.async: no cluster barrier needed)
__device__ __forceinline__ void send(uint32_t slot, uint32_t bar, int dst, float v) {
  uint32_t remote_slot, remote_bar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote_slot) : "r"(slot), "r"(dst));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote_bar) : "r"(bar), "r"(dst));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               ::"r"(remote_slot), "r"(__float_as_uint(v)), "r"(remote_bar) : "memory");
}

// two mbarriers of one arrival each, set up for the cluster (one thread)
__device__ __forceinline__ void init_bars(uint32_t bar0, uint32_t bar1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar0) : "memory");
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar1) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// this CTA's mbarrier `bar` expects `bytes` more in its current phase (one
// thread), and the wait for the phase of parity `parity` to end
__device__ __forceinline__ void expect_bytes(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// the cluster instance: a cluster of c CTAs a lane, CTA k rows [k R, k R + R);
// thread (g, p) rows k R + g RT + a (a < RT) of part p
template <int C, int S, int RT>
__global__ void __launch_bounds__(kClusterMaxThreads, 1)
admm_cluster_kernel(const float* __restrict__ kinv, const float* __restrict__ q_in,
                    const float* __restrict__ lb_in, const float* __restrict__ ub_in,
                    const float* __restrict__ rho_in, const float* __restrict__ x_in,
                    const float* __restrict__ z_in, const float* __restrict__ y_in,
                    float* __restrict__ x_out, float* __restrict__ z_out,
                    float* __restrict__ y_out, int n, int iters, float sigma, float alpha) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const size_t lane = blockIdx.x / c;
  const int L = part_len(n, S), PL = part_stride(L, C);
  const int tail4 = (L - C) / 4;  // float4s of a row part past the registers
  const int T = blockDim.x, t = threadIdx.x;
  const int g = t / S, p = t % S;
  const int R = cluster_rows(n, c);
  // the two buffers' mbarriers, then two buffers of S * PL floats
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* rhs = smem + 4;
  // tailk[(a * tail4 + c4) * T + t]: row a's float4 c4 past the registers;
  // then qlu[(3 a + k) * T + t]: row a's q, lb, ub (k = 0, 1, 2), kept out
  // of the registers, which hold K^-1
  float4* tailk = reinterpret_cast<float4*>(rhs + 2 * S * PL);
  float* qlu = reinterpret_cast<float*>(tailk + RT * tail4 * T);
  const int col0 = p * L;
  // rows past the lane's last hold zeros and keep the barriers
  int row[RT];
  bool own[RT];
  float kr[RT][C];
#pragma unroll
  for (int a = 0; a < RT; ++a) {
    row[a] = rank * R + g * RT + a;
    own[a] = g * RT + a < R && row[a] < n;
    const float* krow = kinv + (lane * n + (own[a] ? row[a] : 0)) * (size_t)n + col0;
#pragma unroll
    for (int k = 0; k < C; ++k) kr[a][k] = own[a] && col0 + k < n ? __ldg(krow + k) : 0.0f;
    for (int c4 = 0; c4 < tail4; ++c4) {
      const int col = col0 + C + 4 * c4;
      const float* kc = krow + C + 4 * c4;
      tailk[(a * tail4 + c4) * T + t] =
          make_float4(own[a] && col < n ? __ldg(kc) : 0.0f,
                      own[a] && col + 1 < n ? __ldg(kc + 1) : 0.0f,
                      own[a] && col + 2 < n ? __ldg(kc + 2) : 0.0f,
                      own[a] && col + 3 < n ? __ldg(kc + 3) : 0.0f);
    }
  }
  // the entries of the rhs buffers that no row writes (part padding) stay 0
  for (int e = t; e < 2 * S * PL; e += T) rhs[e] = 0.0f;
  float x[RT], z[RT], y[RT];
  int pos[RT];  // row a's entry in the rhs vector
  auto q = [&](int a) { return qlu[3 * a * T + t]; };
  auto lb = [&](int a) { return qlu[(3 * a + 1) * T + t]; };
  auto ub = [&](int a) { return qlu[(3 * a + 2) * T + t]; };
#pragma unroll
  for (int a = 0; a < RT; ++a) {
    const size_t at = lane * n + (own[a] ? row[a] : 0);
    qlu[3 * a * T + t] = own[a] ? __ldg(q_in + at) : 0.0f;
    qlu[(3 * a + 1) * T + t] = own[a] ? __ldg(lb_in + at) : 0.0f;
    qlu[(3 * a + 2) * T + t] = own[a] ? __ldg(ub_in + at) : 0.0f;
    x[a] = own[a] ? __ldg(x_in + at) : 0.0f;
    z[a] = own[a] ? __ldg(z_in + at) : 0.0f;
    y[a] = own[a] ? __ldg(y_in + at) : 0.0f;
    pos[a] = own[a] ? (row[a] / L) * PL + row[a] % L : 0;
  }
  const float rho = __ldg(rho_in + lane);
  // y / rho as y (1 / rho): within a rounding of the division, and one
  // multiply on each iteration's chain instead of a division
  const float inv_rho = 1.0f / rho;
  const float one_m_alpha = 1.0f - alpha;
  // buffer b is whole when its mbarrier's phase ends: one arrival (the
  // expected bytes, posted by thread 0) and 4 n bytes, each row's float
  // from the CTA that owns it
  const uint32_t bar0 = smem_u32(bars), bar1 = smem_u32(bars + 1);
  if (t == 0) init_bars(bar0, bar1);
  // every CTA has started, zeroed its buffers and set up its barriers
  // before any remote store
  cluster.sync();
  if (iters > 0) {
    if (t == 0) expect_bytes(bar0, 4 * n);
#pragma unroll
    for (int a = 0; a < RT; ++a) {
      if (own[a]) {
        const float v0 = sigma * x[a] - q(a) + rho * z[a] - y[a];
        for (int dst = p; dst < c; dst += S) send(smem_u32(rhs + pos[a]), bar0, dst, v0);
      }
    }
  }

  for (int it = 0; it < iters; ++it) {
    // buffer it & 1 is whole: its barrier's phase it / 2 has ended
    wait_phase(it & 1 ? bar1 : bar0, (it >> 1) & 1);
    const float4* v4 = reinterpret_cast<const float4*>(rhs + (it & 1) * S * PL + p * PL);
    float* v_next = rhs + ((it + 1) & 1) * S * PL;
    const uint32_t bar_next = it & 1 ? bar0 : bar1;
    // each rhs float4 serves the thread's RT rows; a row part's columns in
    // order into two sums, the even columns' and the odd columns' (half the
    // chain of dependent FMAs), added at the end
    float acc[RT], acc1[RT];
#pragma unroll
    for (int k4 = 0; k4 < C / 4; ++k4) {
      const float4 w = v4[k4];
#pragma unroll
      for (int a = 0; a < RT; ++a) {
        if (k4 == 0) {
          acc[a] = kr[a][0] * w.x;
          acc1[a] = kr[a][1] * w.y;
        } else {
          acc[a] += kr[a][4 * k4] * w.x;
          acc1[a] += kr[a][4 * k4 + 1] * w.y;
        }
        acc[a] += kr[a][4 * k4 + 2] * w.z;
        acc1[a] += kr[a][4 * k4 + 3] * w.w;
      }
    }
#pragma unroll 4
    for (int c4 = 0; c4 < tail4; ++c4) {
      const float4 w = v4[C / 4 + c4];
#pragma unroll
      for (int a = 0; a < RT; ++a) {
        const float4 kk = tailk[(a * tail4 + c4) * T + t];
        acc[a] += kk.x * w.x;
        acc1[a] += kk.y * w.y;
        acc[a] += kk.z * w.z;
        acc1[a] += kk.w * w.w;
      }
    }
#pragma unroll
    for (int a = 0; a < RT; ++a) {
      acc[a] += acc1[a];
#pragma unroll
      for (int m = 1; m < S; m <<= 1) acc[a] += __shfl_xor_sync(kFull, acc[a], m);
      x[a] = acc[a];
      const float z_arg = alpha * x[a] + one_m_alpha * z[a];
      const float z_new = nan_min(nan_max(z_arg + y[a] * inv_rho, lb(a)), ub(a));
      y[a] = y[a] + rho * (z_arg - z_new);
      z[a] = z_new;
    }
    if (it + 1 < iters) {
      // every thread of this CTA has read buffer it & 1 before any of its
      // rows is sent: a CTA writes into another's next buffer only after it
      // has all of that CTA's rows of the current one, so no CTA overwrites
      // a buffer that another still reads; the barrier of the next buffer
      // finished its previous phase (waited on in the last iteration)
      __syncthreads();
      if (t == 0) expect_bytes(bar_next, 4 * n);
#pragma unroll
      for (int a = 0; a < RT; ++a) {
        if (own[a]) {
          const float v = sigma * x[a] - q(a) + rho * z[a] - y[a];
          for (int dst = p; dst < c; dst += S) send(smem_u32(v_next + pos[a]), bar_next, dst, v);
        }
      }
    }
  }
  // every store into this CTA has arrived (each buffer was waited on); the
  // last cluster barrier before any CTA exits
  cluster.sync();

#pragma unroll
  for (int a = 0; a < RT; ++a) {
    if (own[a] && p == 0) {
      const size_t at = lane * n + row[a];
      x_out[at] = x[a];
      z_out[at] = z[a];
      y_out[at] = y[a];
    }
  }
}

// the launch configuration of the cluster instance at size n
cudaLaunchConfig_t cluster_config(const ClusterPlan& plan, int B, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * plan.c);
  cfg.blockDim = dim3(plan.threads);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = plan.c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// opted into once, at the most a CTA may take, so a launch makes no other
// API call and can be captured in a CUDA graph
cudaError_t cluster_attr() {
  static const cudaError_t attr =
      cudaFuncSetAttribute(admm_cluster_kernel<kClusterC, kClusterS, kClusterRows>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  return attr;
}

cudaError_t launch_cluster(const float* kinv, const float* q, const float* lb, const float* ub,
                           const float* rho, const float* x, const float* z, const float* y,
                           float* x_out, float* z_out, float* y_out, int B, int n, int iters,
                           float sigma, float alpha, cudaStream_t stream) {
  const ClusterPlan plan = cluster_plan(n);
  if (plan.c == 0) return cudaErrorInvalidValue;
  const cudaError_t attr = cluster_attr();
  if (attr != cudaSuccess) return attr;
  cudaLaunchAttribute cluster_dim;
  const cudaLaunchConfig_t cfg = cluster_config(plan, B, stream, &cluster_dim);
  return cudaLaunchKernelEx(&cfg, admm_cluster_kernel<kClusterC, kClusterS, kClusterRows>, kinv, q, lb, ub,
                            rho, x, z, y, x_out, z_out, y_out, n, iters, sigma, alpha);
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

// the register instances by n: (C, S, LANES, TAIL, NMAX)
enum Instance { kReg32 = 0, kReg64, kReg128, kReg160, kReg239, kCluster, kStream, kStreamWs };

Instance instance(int n) {
  if (n <= 32) return kReg32;
  if (n <= 64) return kReg64;
  if (n <= 128) return kReg128;
  if (n <= 160) return kReg160;
  if (n <= kMaxN) return kReg239;
  if (n <= kClusterMaxN) return kCluster;
  return n <= kStreamSmemMaxN ? kStream : kStreamWs;
}

}  // namespace

// The launch plan of a call: out[0] the instance (0-4 the register
// instances n <= 32, 64, 128, 160, 239; 5 cluster; 6 streaming; 7 streaming
// on the workspace), out[1] the cluster size (1 outside the cluster
// instance), out[2] the threads a block, out[3] the dynamic shared bytes a
// block; with query nonzero out[4] the clusters of that shape the card can
// hold at once (cudaOccupancyMaxActiveClusters; 0 outside the cluster
// instance). Returns a cudaError_t.
extern "C" int mpc4q_admm_big_plan(int B, int n, int query, int* out) {
  if (B < 1 || n < 1) return cudaErrorInvalidValue;
  const Instance inst = instance(n);
  out[0] = inst;
  out[1] = 1;
  out[4] = 0;
  int T = 0;
  switch (inst) {
    case kReg32:
      out[3] = (int)smem_bytes<32, 1, 4, false>(n, &T);
      out[2] = 4 * T;
      return cudaSuccess;
    case kReg64:
      out[3] = (int)smem_bytes<64, 1, 1, false>(n, &T);
      out[2] = T;
      return cudaSuccess;
    case kReg128:
      out[3] = (int)smem_bytes<64, 2, 1, false>(n, &T);
      out[2] = T;
      return cudaSuccess;
    case kReg160:
      out[3] = (int)smem_bytes<40, 4, 1, false>(n, &T);
      out[2] = T;
      return cudaSuccess;
    case kReg239:
      out[3] = (int)smem_bytes<32, 4, 1, true>(n, &T);
      out[2] = T;
      return cudaSuccess;
    case kStream:
    case kStreamWs:
      out[2] = kStreamThreads;
      out[3] = inst == kStream ? (int)(2 * sizeof(float) * n) : 0;
      return cudaSuccess;
    default:
      break;
  }
  const ClusterPlan plan = cluster_plan(n);
  out[1] = plan.c;
  out[2] = plan.threads;
  out[3] = plan.smem;
  if (!query) return cudaSuccess;
  const cudaError_t attr = cluster_attr();
  if (attr != cudaSuccess) return attr;
  cudaLaunchAttribute cluster_dim;
  const cudaLaunchConfig_t cfg = cluster_config(plan, B, nullptr, &cluster_dim);
  return cudaOccupancyMaxActiveClusters(&out[4], admm_cluster_kernel<kClusterC, kClusterS, kClusterRows>, &cfg);
}

// ws: null, or above n = kStreamSmemMaxN a workspace of B x 2n floats
extern "C" int mpc4q_admm_big(const float* kinv, const float* q, const float* lb,
                              const float* ub, const float* rho, const float* x,
                              const float* z, const float* y, float* x_out, float* z_out,
                              float* y_out, float* ws, int B, int n, int iters, float sigma,
                              float alpha, void* stream) {
  if (n < 1 || iters < 0) return cudaErrorInvalidValue;
  if (B <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS kinv, q, lb, ub, rho, x, z, y, x_out, z_out, y_out, B, n, iters, sigma, alpha, s
  switch (instance(n)) {
    case kReg32: return launch<32, 1, 4, false, 32>(ARGS);
    case kReg64: return launch<64, 1, 1, false, 64>(ARGS);
    case kReg128: return launch<64, 2, 1, false, 128>(ARGS);
    case kReg160: return launch<40, 4, 1, false, 160>(ARGS);
    case kReg239: return launch<32, 4, 1, true, kMaxN>(ARGS);
    case kCluster: return launch_cluster(ARGS);
    default:
      return launch_stream(kinv, q, lb, ub, rho, x, z, y, x_out, z_out, y_out, ws, B, n, iters,
                           sigma, alpha, s);
  }
#undef ARGS
}
