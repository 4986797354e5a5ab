// Batched exponential of complex matrices of any size d >= 1: at d 2-8 a
// team of T threads a matrix, thread j carrying column j of the Taylor
// chain; at d = 1 and 9-32 one block a matrix, each thread a tile of each
// product with its rows of X in registers (the tile instance); at d 33-116
// one thread-block cluster a matrix, each CTA a row panel, P copied to every
// CTA through distributed shared memory (the cluster instance); above
// d 116 one block a matrix on a workspace in device memory (the workspace
// instance). The three are at the end of this file.
//
// Replaces the Pallas TPU kernel mpc4quantum_tpu/ops/pallas_expm.py::_expm_kernel.
// With max_squarings > 0 each matrix takes its 1-norm,
// s = clip(ceil(log2(max(||A||_1, 1))), 0, max_squarings), scales A by 2^-s,
// runs the Horner Taylor of degree taylor_k (P = I + A P / k for k = K..1)
// and squares s times. max_squarings = 0 means the caller has certified
// ||A||_1 <= 1 (plants/quantum.py::taylor_norm_bound): no norm, no scaling,
// no squaring. Each team's loop over its own s squarings gives the same
// result as the TPU kernel's masked squaring.
//
// Layout: the caller's. A and out are row-major (B, d, d) complex64, re and
// im interleaved (float2), so a matrix is 8 d^2 contiguous bytes and
// neighbouring teams read neighbouring matrices; at even d a matrix is read
// as float4s (A 16-byte aligned, which the wrapper ensures). One launch is
// the whole call: no planes, no copies.
//
// What bounds it on the H100: not bytes (16 d^2 a matrix, 0.1-0.6 MB a
// call), but the launch's own latency and each matrix's serial chain of
// taylor_k + s dependent products, and at d = 4, B = 16384 the float32
// issue of those chains (their flops are 1.6 us at the card's float32
// peak, well under 1 us at the other shapes). The first port ran the chain
// in one thread a matrix (96 floats of X, P and a product at d = 4) in
// blocks of 128, so B = 1024 ran on 8 SMs and B = 16384 on 128 blocks with
// nothing to hide the chain's latency.
//
// Design. A team of T threads (T = 2 at d = 2, 4 at d = 3 and 4, 8 at d = 5
// to 8; at d = 3 and 5-7 the lanes j >= d of each team idle, so teams stay
// power-of-two aligned in the warp) solves one matrix. Horner's step needs X and one column of P only:
// column j of P_new is e_j + X P[:, j] / k, so thread j runs the whole
// Taylor chain on its column with no exchange, holding all of X (2 d^2
// floats, loaded once; the team's threads read the same 8 d^2 bytes, which
// L1 serves) and 2 d floats of its column, about 48 floats at d = 4 and 176
// at d = 8 (the 3-qubit plant's 8 x 8 Hamiltonian), within the 255
// registers a thread may hold at 128 threads a block. The
// 1-norm is computed by every thread alone from its copy of X, with a
// NaN-propagating max and clip (jnp.maximum / jnp.clip keep a NaN, fmaxf
// drops it): a matrix holding a NaN comes out all NaN, as from the TPU
// kernel. A squaring needs all of P: column j of P^2 is P P[:, j], summed
// over m = 0..d-1 with column m gathered from thread m by __shfl_sync over
// the team's lanes only, so teams of one warp may take different s. Every
// output element sums m = 0..d-1 in the order of the first port and the
// plain version (ops/expm.py::expm_taylor), each term's two real products
// as two FMAs into the sum: 2d float32 instructions an element, where
// `acc += a*b - c*d` compiles to three (multiply, FMA, add), which saves a
// third of a step's float32 issue. The differences are FMA contraction's.
// 1/k comes from a table in constant memory (the same IEEE quotients), not
// a division in each step.
//
// Block size from B and d: the largest of 128, 64 and 32 threads that still
// gives the grid two blocks for each of the card's 132 SMs, else 32. So
// d = 4 at B = 16384 runs 512 blocks of 128, d = 2 at B = 16384 512 blocks
// of 64, d = 3 at B = 2048 256 blocks of 32 and d = 2 at B = 1024 64 blocks
// of 32, against 128, 128, 16 and 8 blocks of 128 one thread a matrix;
// d = 8 at B = 1024 runs 256 blocks of 32.
//
// The tile instance, d = 1 and 9-32 (kTileMaxD). The team design cannot
// grow: at d = 8 X alone is 128 of a thread's 182 registers. So one block
// takes one matrix, and each thread owns a 2 x 2 tile of every product
// (tile_threads(d) threads: 32 at d 9, 64 at d 16, 256 at d 32). It holds
// its two rows of the scaled X in registers, loaded once a call, and reads
// only its two columns of P from shared memory, one float4 a term, eight
// rows of P loaded together before they are used: four complex FMAs for
// one shared load, where the first block instance loaded one float2 of X
// and one of P for each complex FMA (1 x 4 tiles, tried above d 16, read
// twice the bytes a FMA and ran d 32 slower than that; 2 x 1 tiles at
// d 16, four warps a matrix, ran slower too: PERF.md). The kernel is a
// template on d, as the teams are, so the sum over m = 0..d-1 unrolls; it
// keeps that order and two FMAs a term (cfma), so the result stays within
// float32 rounding of the plain version. P is double-buffered in shared
// memory (2 x 8 d x stride bytes, stride = d rounded up to whole tiles,
// the padded columns zero), one __syncthreads a product. A squaring needs
// rows of P, not of X: each thread stages its two rows of P from shared
// memory into the registers that held X (X is not needed after the Horner
// steps), so the squaring runs the same unrolled product, for 2 d more
// shared loads. The 1-norm is warp 0's (one column a lane) with the
// NaN-propagating max. What bounds it: at B 128 (damped_pair's d 16) one
// 64-thread block an SM, so each product's serial chain (d terms, two
// dependent FMAs each) and its barrier set the pace; at B 1024 the card's
// float32 throughput.
//
// The cluster instance, d = 33-116 (kClusterMaxD). A block can no longer
// hold X in registers, and at small B one block a matrix leaves most SMs
// idle (d 64 at B 16, d 100 at B 4). So one cluster of c CTAs takes one
// matrix: CTA k holds row panel k of X (ceil(d / c) rows) in shared memory
// and a full copy of P, double-buffered, and computes panel k of each
// product, 2 x 2 tiles a thread (X read as two float2 and P as one float4 a
// term); it stores each tile into every CTA's next buffer through
// distributed shared memory (cluster.map_shared_rank), then one
// cluster.sync() a product. The first cluster.sync() comes after every CTA
// has started, before any remote store; the last ends the product loop, so
// no CTA writes to the shared memory of one that has exited. The 1-norm is
// a cluster reduction: each CTA sends its panel's column sums to every CTA,
// each adds the c partial sums in rank order and takes the NaN-propagating
// max, so every CTA finds the same norm and the matrix one squaring count,
// and a NaN matrix comes out all NaN. c (cluster_size) is the least that
// fits 8 stride (2 d + ceil(d / c)) bytes into the 227 KB a CTA may opt
// into (1 up to d 98, 7 at d 116), raised to 132 / B when B is small, at
// most the portable 8, and lowered until no CTA is left without rows: d 64
// at B 16 runs 16 clusters of 8 CTAs, d 100 at B 4 4 clusters of 8. What
// bounds it: each CTA's share of the flops (d^2 ceil(d / c) complex FMAs a
// product) and the c remote copies of its panel a product.
//
// The workspace instance, d > 116: two copies of P no longer fit a CTA's
// shared memory, so one block takes one matrix with X and the two buffers
// of P in the matrix's slice of a workspace in device memory that the
// wrapper allocates (B x 3 x 8 d^2 bytes), thread t the entries t, t +
// blockDim, ... of each product: the first block instance's code, so no d
// is refused. Its loads go through L1 and L2.
//
// mpc4q_expm_small_plan returns the instance, cluster size, threads and
// shared bytes of a call (kernels/expm.py::expm_small_plan computes the
// same), and with `query` the clusters the card can hold at once.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 128;
constexpr int kMinBlocks = 2 * 132;  // two blocks for each SM of an H100

__host__ __device__ constexpr int team_width(int d) { return d <= 2 ? 2 : (d <= 4 ? 4 : 8); }

// 1/k for k <= 32, rounded as the division 1.0f / k rounds
constexpr int kInvMax = 32;
__constant__ float kInv[kInvMax + 1] = {
    0.0f,        1.0f,        1.0f / 2,  1.0f / 3,  1.0f / 4,  1.0f / 5,  1.0f / 6,
    1.0f / 7,    1.0f / 8,    1.0f / 9,  1.0f / 10, 1.0f / 11, 1.0f / 12, 1.0f / 13,
    1.0f / 14,   1.0f / 15,   1.0f / 16, 1.0f / 17, 1.0f / 18, 1.0f / 19, 1.0f / 20,
    1.0f / 21,   1.0f / 22,   1.0f / 23, 1.0f / 24, 1.0f / 25, 1.0f / 26, 1.0f / 27,
    1.0f / 28,   1.0f / 29,   1.0f / 30, 1.0f / 31, 1.0f / 32};

// one complex term of a sum, re += ar br - ai bi and im += ar bi + ai br,
// as two FMAs each
__device__ __forceinline__ void cfma(float ar, float ai, float br, float bi, float& re,
                                     float& im) {
  re = fmaf(-ai, bi, fmaf(ar, br, re));
  im = fmaf(ai, br, fmaf(ar, bi, im));
}

// NaN-propagating max and clip, matching jnp.maximum / jnp.clip.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <int D>
__global__ void __launch_bounds__(kMaxThreads)
expm_small_kernel(const float2* __restrict__ A, float2* __restrict__ out, int B, int taylor_k,
                  int max_squarings) {
  constexpr int T = team_width(D);
  constexpr int E = D * D;
  // blockDim.x is a multiple of 32, so a team never straddles a warp
  const int b = (blockIdx.x * blockDim.x + threadIdx.x) / T;
  const int j = threadIdx.x % T;
  if (b >= B || j >= D) return;
  const unsigned team = ((1u << D) - 1u) << ((threadIdx.x % 32) / T * T);

  float xr[E], xi[E];
  if (D % 2 == 0) {
    const float4* a = reinterpret_cast<const float4*>(A + (size_t)b * E);
#pragma unroll
    for (int e = 0; e < E / 2; ++e) {
      const float4 v = __ldg(a + e);
      xr[2 * e] = v.x;
      xi[2 * e] = v.y;
      xr[2 * e + 1] = v.z;
      xi[2 * e + 1] = v.w;
    }
  } else {
    const float2* a = A + (size_t)b * E;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float2 v = __ldg(a + e);
      xr[e] = v.x;
      xi[e] = v.y;
    }
  }

  int s = 0;
  if (max_squarings > 0) {
    float norm1 = 0.0f;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      float col = 0.0f;
#pragma unroll
      for (int i = 0; i < D; ++i) col += sqrtf(xr[i * D + c] * xr[i * D + c] + xi[i * D + c] * xi[i * D + c]);
      norm1 = c == 0 ? col : nan_max(norm1, col);
    }
    const float sc = clip(ceilf(log2f(nan_max(norm1, 1.0f))), 0.0f, (float)max_squarings);
    s = sc == sc ? (int)sc : 0;  // a NaN norm scales X to NaN and squares nothing
    const float scale = exp2f(-sc);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      xr[e] *= scale;
      xi[e] *= scale;
    }
  }

  // Horner Taylor on column j: p = e_j; for k = K..1: p = e_j + X p / k
  float pr[D], pi[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    pr[i] = i == j ? 1.0f : 0.0f;
    pi[i] = 0.0f;
  }
  for (int k = taylor_k; k >= 1; --k) {
    float tr[D], ti[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      tr[i] = xr[i * D] * pr[0] - xi[i * D] * pi[0];
      ti[i] = xr[i * D] * pi[0] + xi[i * D] * pr[0];
#pragma unroll
      for (int m = 1; m < D; ++m) cfma(xr[i * D + m], xi[i * D + m], pr[m], pi[m], tr[i], ti[i]);
    }
    const float inv_k = k <= kInvMax ? kInv[k] : 1.0f / (float)k;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      pr[i] = (i == j ? 1.0f : 0.0f) + tr[i] * inv_k;
      pi[i] = ti[i] * inv_k;
    }
  }

  // s squarings: column j of P^2 = sum_m P[:, m] P[m, j], column m from thread m
  for (int step = 0; step < s; ++step) {
    float tr[D], ti[D];
#pragma unroll
    for (int m = 0; m < D; ++m) {
      float cr[D], ci[D];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        cr[i] = __shfl_sync(team, pr[i], m, T);
        ci[i] = __shfl_sync(team, pi[i], m, T);
      }
#pragma unroll
      for (int i = 0; i < D; ++i) {
        if (m == 0) {
          tr[i] = cr[i] * pr[0] - ci[i] * pi[0];
          ti[i] = cr[i] * pi[0] + ci[i] * pr[0];
        } else {
          cfma(cr[i], ci[i], pr[m], pi[m], tr[i], ti[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < D; ++i) {
      pr[i] = tr[i];
      pi[i] = ti[i];
    }
  }

  float2* o = out + (size_t)b * E;
#pragma unroll
  for (int i = 0; i < D; ++i) o[i * D + j] = make_float2(pr[i], pi[i]);
}

// the block of the team instances: the largest of 128, 64 and 32 threads
// that still gives the grid two blocks for each SM, else 32
int team_block(int B, int d) {
  const long long threads = (long long)B * team_width(d);
  int block = kMaxThreads;
  while (block > 32 && (threads + block - 1) / block < kMinBlocks) block /= 2;
  return block;
}

int team_blocks(int B, int d) {
  const int block = team_block(B, d);
  return (int)(((long long)B * team_width(d) + block - 1) / block);
}

// the NaN-propagating max over the block, returned to every thread
// (blockDim.x a multiple of 32; scratch: 32 floats of shared memory)
__device__ float block_nan_max(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = v;
  __syncthreads();
  v = threadIdx.x % 32 < blockDim.x / 32 ? scratch[threadIdx.x % 32] : 0.0f;
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// s and the scale 2^-s from a matrix's 1-norm
__device__ __forceinline__ float squarings(float norm1, int max_squarings, int* s) {
  const float sc = clip(ceilf(log2f(nan_max(norm1, 1.0f))), 0.0f, (float)max_squarings);
  *s = sc == sc ? (int)sc : 0;  // a NaN norm scales X to NaN and squares nothing
  return exp2f(-sc);
}

__device__ __forceinline__ float inv_step(int k) { return k <= kInvMax ? kInv[k] : 1.0f / (float)k; }

// ---------------------------------------------------------------------------
// The tile instance, d = 1 and 9..kTileMaxD: one block a matrix, a thread a
// TR x TC tile of each product with its TR rows of X in registers.

constexpr int kTileMaxD = 32;
constexpr int kTileMaxThreads = 256;

// a thread's tile of a product, and the rows of P it loads together
// before it uses them
constexpr int kTileRows = 2, kTileCols = 2;
constexpr int kTileChunk = 8;

// the row stride of P in shared memory: whole tiles of columns (even)
__host__ __device__ constexpr int tile_stride(int d) {
  return (d + kTileCols - 1) / kTileCols * kTileCols;
}
__host__ __device__ constexpr int tile_threads(int d) {
  return ((d + kTileRows - 1) / kTileRows * (tile_stride(d) / kTileCols) + 31) / 32 * 32;
}
// two buffers of P, d x stride complex, and one float for the norm
__host__ __device__ constexpr int tile_smem(int d) {
  return 2 * 8 * d * tile_stride(d) + 16;
}

template <int D>
__global__ void __launch_bounds__(kTileMaxThreads)
expm_tile_kernel(const float2* __restrict__ A, float2* __restrict__ out, int taylor_k,
                 int max_squarings) {
  constexpr int TR = kTileRows, TC = kTileCols, DP = tile_stride(D);
  constexpr int NTC = DP / TC, NTR = (D + TR - 1) / TR;
  extern __shared__ __align__(16) float2 smem2[];
  float2* cur = smem2;        // the current iterate P, D x DP
  float2* nxt = smem2 + D * DP;
  float* norm_slot = reinterpret_cast<float*>(smem2 + 2 * D * DP);
  const int t = threadIdx.x;
  const size_t b = blockIdx.x;
  // P = I in one buffer, A in the other (the padded columns zero in both)
  const float2* a = A + b * D * D;
  for (int e = t; e < D * DP; e += blockDim.x) {
    const int i = e / DP, j = e - i * DP;
    cur[e] = make_float2(i == j ? 1.0f : 0.0f, 0.0f);
    nxt[e] = j < D ? __ldg(a + i * D + j) : make_float2(0.0f, 0.0f);
  }
  __syncthreads();
  int s = 0;
  float scale = 1.0f;
  if (max_squarings > 0) {
    if (t < 32) {  // D <= 32: one column a lane of warp 0
      float col = 0.0f;
      if (t < D) {
#pragma unroll 4
        for (int i = 0; i < D; ++i) {
          const float2 v = nxt[i * DP + t];
          col += sqrtf(v.x * v.x + v.y * v.y);
        }
      }
      for (int o = 16; o > 0; o >>= 1) col = nan_max(col, __shfl_xor_sync(0xffffffffu, col, o));
      if (t == 0) *norm_slot = col;
    }
    __syncthreads();
    scale = squarings(*norm_slot, max_squarings, &s);
  }
  // this thread's tile: rows i0.., columns j0..; threads past the last tile
  // hold zeros and keep the barriers
  const bool active = t < NTR * NTC;
  const int i0 = active ? t / NTC * TR : 0, j0 = active ? t % NTC * TC : 0;
  float xr[TR][D], xi[TR][D];
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int m = 0; m < D; ++m) {
      const float2 v = active && i0 + r < D ? nxt[(i0 + r) * DP + m] : make_float2(0.0f, 0.0f);
      xr[r][m] = v.x * scale;
      xi[r][m] = v.y * scale;
    }
  __syncthreads();

  // taylor_k Horner steps P = I + X P / k (k = K..1), then s squarings
  // P = P P, whose rows come from P itself: each thread stages its TR rows
  // of P from shared memory into the registers that held X, which the
  // Horner steps no longer need
  for (int step = 0; step < taylor_k + s; ++step) {
    const bool horner = step < taylor_k;
    const float inv_k = horner ? inv_step(taylor_k - step) : 1.0f;
    if (!horner) {
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int m = 0; m < D; ++m) {
          const float2 v = active && i0 + r < D ? cur[(i0 + r) * DP + m] : make_float2(0.0f, 0.0f);
          xr[r][m] = v.x;
          xi[r][m] = v.y;
        }
    }
    // sum over m = 0..D-1 in order, two FMAs a term (cfma); P's rows m of
    // this tile's columns as TC / 2 float4 loads, kTileChunk rows loaded
    // together before they are used, so their latencies overlap
    constexpr int MB = D < kTileChunk ? D : kTileChunk;
    float ar[TR][TC], ai[TR][TC];
#pragma unroll
    for (int m0 = 0; m0 < D; m0 += MB) {
      float pr[MB][TC], pi[MB][TC];
#pragma unroll
      for (int mm = 0; mm < MB; ++mm) {
        if (m0 + mm < D) {
          const float4* row = reinterpret_cast<const float4*>(cur + (m0 + mm) * DP + j0);
#pragma unroll
          for (int h = 0; h < TC / 2; ++h) {
            const float4 v = row[h];
            pr[mm][2 * h] = v.x;
            pi[mm][2 * h] = v.y;
            pr[mm][2 * h + 1] = v.z;
            pi[mm][2 * h + 1] = v.w;
          }
        }
      }
#pragma unroll
      for (int mm = 0; mm < MB; ++mm) {
        const int m = m0 + mm;
        if (m < D) {
#pragma unroll
          for (int r = 0; r < TR; ++r)
#pragma unroll
            for (int c = 0; c < TC; ++c) {
              if (m == 0) {
                ar[r][c] = xr[r][0] * pr[0][c] - xi[r][0] * pi[0][c];
                ai[r][c] = xr[r][0] * pi[0][c] + xi[r][0] * pr[0][c];
              } else {
                cfma(xr[r][m], xi[r][m], pr[mm][c], pi[mm][c], ar[r][c], ai[r][c]);
              }
            }
        }
      }
    }
    if (active) {
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int c = 0; c < TC; ++c) {
          const int i = i0 + r, j = j0 + c;
          if (i < D && j < D)
            nxt[i * DP + j] = horner ? make_float2((i == j ? 1.0f : 0.0f) + ar[r][c] * inv_k,
                                                   ai[r][c] * inv_k)
                                     : make_float2(ar[r][c], ai[r][c]);
        }
    }
    __syncthreads();
    float2* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  float2* o = out + b * D * D;
  for (int e = t; e < D * D; e += blockDim.x) {
    const int i = e / D;
    o[e] = cur[i * DP + e - i * D];
  }
}

template <int D>
cudaError_t launch_tile(const float2* A, float2* out, int B, int taylor_k, int max_squarings,
                        cudaStream_t stream) {
  static_assert(tile_threads(D) <= kTileMaxThreads, "tile instance threads");
  static_assert(tile_smem(D) <= 48 * 1024, "tile instance shared memory");
  expm_tile_kernel<D><<<B, tile_threads(D), tile_smem(D), stream>>>(A, out, taylor_k,
                                                                     max_squarings);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The cluster instance, kTileMaxD < d <= kClusterMaxD: one cluster of c CTAs
// a matrix, CTA k computing row panel k of each product and sending it to
// every CTA's copy of P through distributed shared memory.

constexpr int kClusterMaxD = 116;
constexpr int kMaxCluster = 8;        // the portable cluster size
constexpr int kClusterMaxThreads = 1024;
constexpr int kSMs = 132;             // an H100 SXM's SMs
constexpr int kMaxSmem = 232448;      // the shared memory a block may opt into

__host__ __device__ constexpr int cluster_stride(int d) { return (d + 1) / 2 * 2; }
__host__ __device__ constexpr int cluster_panel(int d, int c) { return (d + c - 1) / c; }
// P double-buffered (d x stride complex each) and this CTA's panel of X;
// the norm's partial column sums (c x stride floats) and the block's
// reduction scratch borrow the second buffer before the first product
__host__ __device__ constexpr int cluster_smem(int d, int c) {
  return 8 * cluster_stride(d) * (2 * d + cluster_panel(d, c));
}
__host__ __device__ constexpr int cluster_threads(int d, int c) {
  const int tiles = (cluster_panel(d, c) + 1) / 2 * (cluster_stride(d) / 2);
  return tiles >= kClusterMaxThreads ? kClusterMaxThreads : (tiles + 31) / 32 * 32;
}
// the cluster size: the least c whose CTA fits the shared memory, raised
// to fill the SMs when B is small (at most kMaxCluster), then lowered
// while the last CTA would get no rows
__host__ __device__ constexpr int cluster_size(int B, int d) {
  int c = 1;
  while (c < kMaxCluster && cluster_smem(d, c) > kMaxSmem) ++c;
  const int fill = B >= kSMs ? 1 : kSMs / B;
  if (fill > c) c = fill < kMaxCluster ? fill : kMaxCluster;
  while (c > 1 && (c - 1) * cluster_panel(d, c) >= d && cluster_smem(d, c - 1) <= kMaxSmem) --c;
  return c;
}
static_assert(cluster_smem(kClusterMaxD, kMaxCluster) <= kMaxSmem, "cluster instance range");
static_assert(cluster_smem(kClusterMaxD + 1, kMaxCluster) > kMaxSmem, "cluster instance range");

__global__ void __launch_bounds__(kClusterMaxThreads, 1)
expm_cluster_kernel(const float2* __restrict__ A, float2* __restrict__ out, int d, int taylor_k,
                    int max_squarings) {
  extern __shared__ __align__(16) float2 smem2[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const size_t b = blockIdx.x / c;
  const int DP = cluster_stride(d), RP = cluster_panel(d, c);
  const int r0 = rank * RP;
  const int rows = d - r0 < RP ? d - r0 : RP;  // >= 1 (cluster_size)
  const int t = threadIdx.x, T = blockDim.x;
  float2* cur = smem2;
  float2* nxt = smem2 + d * DP;
  float2* xp = smem2 + 2 * d * DP;  // rows r0..r0+rows of X, stride DP
  float* colpart = reinterpret_cast<float*>(nxt);  // c x DP, before the first product
  float* scratch = colpart + c * DP;
  const float2* a = A + b * d * d;
  for (int e = t; e < d * DP; e += T) {
    const int i = e / DP;
    cur[e] = make_float2(i == e - i * DP ? 1.0f : 0.0f, 0.0f);
  }
  for (int e = t; e < rows * DP; e += T) {
    const int r = e / DP, j = e - r * DP;
    xp[e] = j < d ? __ldg(a + (size_t)(r0 + r) * d + j) : make_float2(0.0f, 0.0f);
  }
  // every CTA of the cluster has started (and its panel is loaded) before
  // any CTA writes to another's shared memory
  cluster.sync();
  int s = 0;
  if (max_squarings > 0) {
    // the 1-norm: the panel's column sums to every CTA, then each CTA adds
    // the c partial sums in rank order (the same norm in every CTA) and
    // takes the NaN-propagating max over the columns
    for (int j = t; j < d; j += T) {
      float col = 0.0f;
      for (int r = 0; r < rows; ++r) {
        const float2 v = xp[r * DP + j];
        col += sqrtf(v.x * v.x + v.y * v.y);
      }
      for (int dst = 0; dst < c; ++dst) cluster.map_shared_rank(colpart, dst)[rank * DP + j] = col;
    }
    cluster.sync();
    float norm1 = 0.0f;
    for (int j = t; j < d; j += T) {
      float col = 0.0f;
      for (int k = 0; k < c; ++k) col += colpart[k * DP + j];
      norm1 = nan_max(norm1, col);
    }
    const float scale = squarings(block_nan_max(norm1, scratch), max_squarings, &s);
    for (int e = t; e < rows * DP; e += T) {
      xp[e].x *= scale;
      xp[e].y *= scale;
    }
    // no CTA reads its partial sums any more: the buffer may take products
    cluster.sync();
  }
  // the second buffer's padded column (odd d) is never written by a product
  if (DP > d)
    for (int i = t; i < d; i += T) nxt[i * DP + d] = make_float2(0.0f, 0.0f);

  // each thread takes 2 x 2 tiles of the panel: rows ra, ra + 1 of the
  // panel, columns j0, j0 + 1
  const int ntc = DP / 2, ntiles = (rows + 1) / 2 * ntc;
  for (int step = 0; step < taylor_k + s; ++step) {
    const bool horner = step < taylor_k;
    const float inv_k = horner ? inv_step(taylor_k - step) : 1.0f;
    // the rows: X's panel (Horner) or the same rows of P (a squaring)
    const float2* src = horner ? xp : cur + (size_t)r0 * DP;
    for (int tile = t; tile < ntiles; tile += T) {
      const int ra = tile / ntc * 2, j0 = (tile - tile / ntc * ntc) * 2;
      const bool two = ra + 1 < rows;
      const float2* xa = src + ra * DP;
      const float2* xb = src + (two ? ra + 1 : ra) * DP;
      const float4* pc = reinterpret_cast<const float4*>(cur + j0);
      const int pstride = DP / 2;
      float a0r, a0i, a1r, a1i, b0r, b0i, b1r, b1i;
      {
        const float2 x0 = xa[0], x1 = xb[0];
        const float4 p = pc[0];
        a0r = x0.x * p.x - x0.y * p.y;
        a0i = x0.x * p.y + x0.y * p.x;
        a1r = x0.x * p.z - x0.y * p.w;
        a1i = x0.x * p.w + x0.y * p.z;
        b0r = x1.x * p.x - x1.y * p.y;
        b0i = x1.x * p.y + x1.y * p.x;
        b1r = x1.x * p.z - x1.y * p.w;
        b1i = x1.x * p.w + x1.y * p.z;
      }
#pragma unroll 4
      for (int m = 1; m < d; ++m) {
        const float2 x0 = xa[m], x1 = xb[m];
        const float4 p = pc[m * pstride];
        cfma(x0.x, x0.y, p.x, p.y, a0r, a0i);
        cfma(x0.x, x0.y, p.z, p.w, a1r, a1i);
        cfma(x1.x, x1.y, p.x, p.y, b0r, b0i);
        cfma(x1.x, x1.y, p.z, p.w, b1r, b1i);
      }
      const int ia = r0 + ra, ib = ia + 1;
      float4 va, vb;
      if (horner) {
        va = make_float4((ia == j0 ? 1.0f : 0.0f) + a0r * inv_k, a0i * inv_k,
                         (ia == j0 + 1 ? 1.0f : 0.0f) + a1r * inv_k, a1i * inv_k);
        vb = make_float4((ib == j0 ? 1.0f : 0.0f) + b0r * inv_k, b0i * inv_k,
                         (ib == j0 + 1 ? 1.0f : 0.0f) + b1r * inv_k, b1i * inv_k);
      } else {
        va = make_float4(a0r, a0i, a1r, a1i);
        vb = make_float4(b0r, b0i, b1r, b1i);
      }
      // the tile to every CTA's next buffer; at an odd d the last column
      // pair holds one real column
      const bool pair = j0 + 1 < d;
      for (int dst = 0; dst < c; ++dst) {
        float2* remote = cluster.map_shared_rank(nxt, dst);
        if (pair) {
          *reinterpret_cast<float4*>(remote + (size_t)ia * DP + j0) = va;
          if (two) *reinterpret_cast<float4*>(remote + (size_t)ib * DP + j0) = vb;
        } else {
          remote[(size_t)ia * DP + j0] = make_float2(va.x, va.y);
          if (two) remote[(size_t)ib * DP + j0] = make_float2(vb.x, vb.y);
        }
      }
    }
    // every product of the step is in every CTA's next buffer; also the
    // last cluster barrier before any CTA exits, so no CTA writes to the
    // shared memory of one that has exited
    cluster.sync();
    float2* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  float2* o = out + b * d * d;
  for (int e = t; e < rows * d; e += T) {
    const int r = e / d, j = e - r * d;
    o[(size_t)(r0 + r) * d + j] = cur[(size_t)(r0 + r) * DP + j];
  }
}

cudaError_t launch_cluster(const float2* A, float2* out, int B, int d, int taylor_k,
                           int max_squarings, cudaStream_t stream) {
  // opted into once, at the most any CTA takes, so a launch makes no other
  // API call and can be captured in a CUDA graph
  static const cudaError_t attr = cudaFuncSetAttribute(
      expm_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const int c = cluster_size(B, d);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * c);
  cfg.blockDim = dim3(cluster_threads(d, c));
  cfg.dynamicSmemBytes = cluster_smem(d, c);
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = c;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, expm_cluster_kernel, A, out, d, taylor_k, max_squarings);
}

// ---------------------------------------------------------------------------
// The workspace instance, d > kClusterMaxD: one block a matrix, X and the
// two buffers of P in the matrix's slice of a workspace in device memory.

constexpr int kWorkspaceThreads = 1024;

// out = (I if diag else 0) + X P * scale over the block's entries,
// summed over m = 0..d-1 in order
__device__ __forceinline__ void block_product(const float2* X, const float2* P, float2* out,
                                              int d, float scale, bool diag) {
  const int E = d * d;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int i = e / d, j = e - i * d;
    const float2* x = X + i * d;
    const float2 x0 = x[0], p0 = P[j];
    float re = x0.x * p0.x - x0.y * p0.y;
    float im = x0.x * p0.y + x0.y * p0.x;
    for (int m = 1; m < d; ++m) {
      const float2 xm = x[m], pm = P[m * d + j];
      cfma(xm.x, xm.y, pm.x, pm.y, re, im);
    }
    out[e] = diag ? make_float2((i == j ? 1.0f : 0.0f) + re * scale, im * scale)
                  : make_float2(re, im);
  }
}

// one block an SM at the most threads: ptxas may take 64 registers a thread
__global__ void __launch_bounds__(kWorkspaceThreads, 1)
expm_workspace_kernel(const float2* __restrict__ A, float2* __restrict__ out, float2* ws, int d,
                      int taylor_k, int max_squarings) {
  extern __shared__ __align__(16) float scratch[];  // 32 floats: the norm's reduction
  const int E = d * d;
  const size_t b = blockIdx.x;
  // X, then the two buffers of P, in the matrix's slice of the workspace
  float2* X = ws + b * 3 * E;
  float2* p = X + E;  // the current iterate
  float2* p_next = X + 2 * E;
  const float2* a = A + b * E;
  for (int e = threadIdx.x; e < E; e += blockDim.x) X[e] = __ldg(a + e);
  __syncthreads();

  int s = 0;
  if (max_squarings > 0) {
    float norm1 = 0.0f;
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      float col = 0.0f;
      for (int i = 0; i < d; ++i) {
        const float2 v = X[i * d + c];
        col += sqrtf(v.x * v.x + v.y * v.y);
      }
      norm1 = nan_max(norm1, col);
    }
    const float scale = squarings(block_nan_max(norm1, scratch), max_squarings, &s);
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
      X[e].x *= scale;
      X[e].y *= scale;
    }
  }
  for (int e = threadIdx.x; e < E; e += blockDim.x)
    p[e] = make_float2(e / d == e % d ? 1.0f : 0.0f, 0.0f);
  __syncthreads();

  // Horner Taylor: P = I + X P / k for k = K..1; then s squarings
  for (int k = taylor_k; k >= 1; --k) {
    block_product(X, p, p_next, d, inv_step(k), true);
    __syncthreads();
    float2* t = p;
    p = p_next;
    p_next = t;
  }
  for (int step = 0; step < s; ++step) {
    block_product(p, p, p_next, d, 1.0f, false);
    __syncthreads();
    float2* t = p;
    p = p_next;
    p_next = t;
  }
  float2* o = out + b * E;
  for (int e = threadIdx.x; e < E; e += blockDim.x) o[e] = p[e];
}

cudaError_t launch_workspace(const float2* A, float2* out, float2* ws, int B, int d, int taylor_k,
                             int max_squarings, cudaStream_t stream) {
  if (ws == nullptr) return cudaErrorInvalidValue;
  const int E = d * d;
  const int threads = E >= kWorkspaceThreads ? kWorkspaceThreads : (E + 31) / 32 * 32;
  expm_workspace_kernel<<<B, threads, 32 * sizeof(float), stream>>>(A, out, ws, d, taylor_k,
                                                                    max_squarings);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const float2* A, float2* out, int B, int taylor_k, int max_squarings,
                   cudaStream_t stream) {
  expm_small_kernel<D><<<team_blocks(B, D), team_block(B, D), 0, stream>>>(A, out, B, taylor_k,
                                                                           max_squarings);
  return cudaGetLastError();
}

enum Instance { kTeam = 0, kTile = 1, kCluster = 2, kWorkspace = 3 };

Instance instance(int d) {
  if (d >= 2 && d <= 8) return kTeam;
  if (d <= kTileMaxD) return kTile;
  return d <= kClusterMaxD ? kCluster : kWorkspace;
}

}  // namespace

// The launch plan of a call: out[0] the instance (0 team, 1 tile, 2
// cluster, 3 workspace), out[1] the cluster size (1 outside the cluster
// instance), out[2] the threads a block, out[3] the dynamic shared bytes a
// block; with query nonzero out[4] the clusters of that shape the card can
// hold at once (cudaOccupancyMaxActiveClusters; 0 outside the cluster
// instance). Returns a cudaError_t.
extern "C" int mpc4q_expm_small_plan(int B, int d, int query, int* out) {
  if (B < 1 || d < 1) return cudaErrorInvalidValue;
  const Instance inst = instance(d);
  out[0] = inst;
  out[1] = inst == kCluster ? cluster_size(B, d) : 1;
  out[4] = 0;
  switch (inst) {
    case kTeam:
      out[2] = team_block(B, d);
      out[3] = 0;
      return cudaSuccess;
    case kTile:
      out[2] = tile_threads(d);
      out[3] = tile_smem(d);
      return cudaSuccess;
    case kWorkspace:
      out[2] = d * d >= kWorkspaceThreads ? kWorkspaceThreads : (d * d + 31) / 32 * 32;
      out[3] = 32 * sizeof(float);
      return cudaSuccess;
    default:
      break;
  }
  out[2] = cluster_threads(d, out[1]);
  out[3] = cluster_smem(d, out[1]);
  if (!query) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(expm_cluster_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * out[1]);
  cfg.blockDim = dim3(out[2]);
  cfg.dynamicSmemBytes = out[3];
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = out[1];
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(&out[4], expm_cluster_kernel, &cfg);
}

// ws: null, or at d > kClusterMaxD a workspace of B x 3 x d^2 float2
extern "C" int mpc4q_expm_small(const void* A, void* out, void* ws, int B, int d, int taylor_k,
                                int max_squarings, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (d < 1 || taylor_k < 1 || max_squarings < 0) return cudaErrorInvalidValue;
  if (d % 2 == 0 && reinterpret_cast<uintptr_t>(A) % 16 != 0) return cudaErrorMisalignedAddress;
  const float2* a = static_cast<const float2*>(A);
  float2* o = static_cast<float2*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TILE(D) \
  case D:       \
    return launch_tile<D>(a, o, B, taylor_k, max_squarings, s);
  switch (d) {
    case 2: return launch<2>(a, o, B, taylor_k, max_squarings, s);
    case 3: return launch<3>(a, o, B, taylor_k, max_squarings, s);
    case 4: return launch<4>(a, o, B, taylor_k, max_squarings, s);
    case 5: return launch<5>(a, o, B, taylor_k, max_squarings, s);
    case 6: return launch<6>(a, o, B, taylor_k, max_squarings, s);
    case 7: return launch<7>(a, o, B, taylor_k, max_squarings, s);
    case 8: return launch<8>(a, o, B, taylor_k, max_squarings, s);
    TILE(1) TILE(9) TILE(10) TILE(11) TILE(12) TILE(13) TILE(14) TILE(15) TILE(16)
    TILE(17) TILE(18) TILE(19) TILE(20) TILE(21) TILE(22) TILE(23) TILE(24)
    TILE(25) TILE(26) TILE(27) TILE(28) TILE(29) TILE(30) TILE(31) TILE(32)
    default:
      break;
  }
#undef TILE
  if (d <= kClusterMaxD) return launch_cluster(a, o, B, d, taylor_k, max_squarings, s);
  return launch_workspace(a, o, static_cast<float2*>(ws), B, d, taylor_k, max_squarings, s);
}
