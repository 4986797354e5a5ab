// Batched exponential of complex matrices of any size d >= 1: at d 2-8 a
// team of T threads a matrix, thread j carrying column j of the Taylor
// chain; at every other d one thread block a matrix (the block instance,
// at the end of this file).
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
// The block instance, d = 1 and d >= 9. The team design cannot grow: at
// d = 8 X alone is 128 of a thread's 182 registers. So one thread block
// takes one matrix, X and the Horner iterate P live in shared memory (P
// double-buffered: the step reads one buffer and writes the other, one
// __syncthreads a step), and thread t computes the entries e = t, t +
// blockDim, ... of each product: P_new[i, j] = delta_ij + sum_m X[i, m]
// P[m, j] / k, summed over m = 0..d-1 in order as everywhere above, so the
// result sits within float32 rounding of the plain version. A squaring is
// the same loop with P in place of X. The 1-norm is a block reduction of
// the column sums with the NaN-propagating max, and each matrix takes its
// own squarings, as in the team instances. 3 x 8 d^2 bytes of shared memory
// a block fit the 227 KB a block may hold up to d = 97 (kSmemMaxD; opted
// into once, so launches capture in CUDA graphs); above it the same code
// runs on a workspace in device memory that the wrapper allocates
// (B x 3 x 8 d^2 bytes), so no d is refused. The block has min(1024,
// 32 ceil(d^2 / 32)) threads: one entry a thread up to d 32 (256 threads
// at d 16), several from d 33. What bounds it: a step is d shared loads of X and of P
// and d complex FMAs an entry, all threads of the block in lockstep behind
// the barrier; B below the SM count leaves SMs idle (d 64 at B 16, d 100 at
// B 4). A tiled product (a thread owning a 2 x 2 or 4 x 4 tile of P, X and
// P read once a tile) is the next step (ROADMAP queue 2).

#include <cuda_runtime.h>

#include <cstdint>

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

constexpr int kBlockMaxThreads = 1024;
// the largest d whose X and two P buffers, 3 x 8 d^2 bytes, fit the
// 227 KB of shared memory a block may opt into
constexpr int kSmemMaxD = 97;

// the NaN-propagating max over the block, returned to every thread
// (blockDim.x a multiple of 32)
__device__ float block_nan_max(float v) {
  __shared__ float warp_max[32];
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = v;
  __syncthreads();
  v = threadIdx.x % 32 < blockDim.x / 32 ? warp_max[threadIdx.x % 32] : 0.0f;
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

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
template <bool SMEM>
__global__ void __launch_bounds__(kBlockMaxThreads, 1)
expm_block_kernel(const float2* __restrict__ A, float2* __restrict__ out, float2* ws, int d,
                  int taylor_k, int max_squarings) {
  extern __shared__ __align__(16) float2 smem[];
  const int E = d * d;
  const size_t b = blockIdx.x;
  // X, then the two buffers of P: in shared memory, or the matrix's slice
  // of the workspace
  float2* X = SMEM ? smem : ws + b * 3 * E;
  float2* p = X + E;      // the current iterate
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
    norm1 = block_nan_max(norm1);
    const float sc = clip(ceilf(log2f(nan_max(norm1, 1.0f))), 0.0f, (float)max_squarings);
    s = sc == sc ? (int)sc : 0;  // a NaN norm scales X to NaN and squares nothing
    const float scale = exp2f(-sc);
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
    const float inv_k = k <= kInvMax ? kInv[k] : 1.0f / (float)k;
    block_product(X, p, p_next, d, inv_k, true);
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

cudaError_t launch_block(const float2* A, float2* out, float2* ws, int B, int d, int taylor_k,
                         int max_squarings, cudaStream_t stream) {
  const int E = d * d;
  const int threads = E >= kBlockMaxThreads ? kBlockMaxThreads : (E + 31) / 32 * 32;
  if (d <= kSmemMaxD) {
    // opted into once, at the largest d, so a launch makes no other API call
    static const size_t smem_max = 3 * sizeof(float2) * kSmemMaxD * kSmemMaxD;
    static const cudaError_t attr = cudaFuncSetAttribute(
        expm_block_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_max);
    if (attr != cudaSuccess) return attr;
    expm_block_kernel<true><<<B, threads, 3 * sizeof(float2) * E, stream>>>(
        A, out, nullptr, d, taylor_k, max_squarings);
  } else {
    if (ws == nullptr) return cudaErrorInvalidValue;
    expm_block_kernel<false><<<B, threads, 0, stream>>>(A, out, ws, d, taylor_k, max_squarings);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const float2* A, float2* out, int B, int taylor_k, int max_squarings,
                   cudaStream_t stream) {
  const long long threads = (long long)B * team_width(D);
  int block = kMaxThreads;
  while (block > 32 && (threads + block - 1) / block < kMinBlocks) block /= 2;
  const int blocks = (int)((threads + block - 1) / block);
  expm_small_kernel<D><<<blocks, block, 0, stream>>>(A, out, B, taylor_k, max_squarings);
  return cudaGetLastError();
}

}  // namespace

// ws: null, or at d > kSmemMaxD a workspace of B x 3 x d^2 float2
extern "C" int mpc4q_expm_small(const void* A, void* out, void* ws, int B, int d, int taylor_k,
                                int max_squarings, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (d < 1 || taylor_k < 1 || max_squarings < 0) return cudaErrorInvalidValue;
  if (d % 2 == 0 && reinterpret_cast<uintptr_t>(A) % 16 != 0) return cudaErrorMisalignedAddress;
  const float2* a = static_cast<const float2*>(A);
  float2* o = static_cast<float2*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 2: return launch<2>(a, o, B, taylor_k, max_squarings, s);
    case 3: return launch<3>(a, o, B, taylor_k, max_squarings, s);
    case 4: return launch<4>(a, o, B, taylor_k, max_squarings, s);
    case 5: return launch<5>(a, o, B, taylor_k, max_squarings, s);
    case 6: return launch<6>(a, o, B, taylor_k, max_squarings, s);
    case 7: return launch<7>(a, o, B, taylor_k, max_squarings, s);
    case 8: return launch<8>(a, o, B, taylor_k, max_squarings, s);
    default:
      return launch_block(a, o, static_cast<float2*>(ws), B, d, taylor_k, max_squarings, s);
  }
}
