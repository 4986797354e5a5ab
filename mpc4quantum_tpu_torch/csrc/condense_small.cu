// The model phase of small condensed QPs: a team of W threads per lane,
// dim_x <= 16 and n = H dim_u <= 16.
//
// Replaces no Pallas kernel: the JAX package leaves these contractions to
// XLA (mpc4quantum_tpu/ops/bilinear.py::model_along_traj and
// mpc4quantum_tpu/solvers/condense.py::qp_data). It was added because the
// port's plain form of them, ops/bilinear.py::model_along_traj followed by
// solvers/condense.py::qp_data, is a chain of some sixty batched GEMMs and
// GEMVs on 4 x 4 complex operators, each of which passes the whole fleet's
// intermediates through device memory. Here one launch does, for each lane,
//   - the monomials f(u_t) and their gradient df/du(u_t) (lift_controls'
//     order of products),
//   - the rows of A_t = A + sum_l f_l(u_t) N_l, B_t = (N x_t) df(u_t)^T and
//     Delta_t = -B_t u_t,
//   - the recurrence w_{t+1} = Delta_t + A_t w_t, M_{t+1} = A_t M_t, with B_t
//     in M's columns of step t,
//   - P += Re(M_t^H Q_t M_t), q += Re(M_t^H Q_t (w_t - xbm_t)) as it goes,
//   - the block-diagonal R term, and lb, ub from sat, du and u_prev,
// and writes P, q, lb, ub (float32) and w, M (complex64), as qp_data
// returns them. No A_t, B_t, Delta_t or per-step product leaves the SM.
//
// Layout: the caller's strides (in elements) for every input, so views of
// the runner's tensors (the guess X = Xg[:, :, :H], the window of the
// targets, an expanded u_prev or R) are read in place. A (dim_x, dim_x), N
// (dim_x, Lm, dim_x), X (B, dim_x, H) complex; U (B, dim_u, H) real; x_init
// (B, dim_x); X_bm (dim_x, H + 1); U_bm (dim_u, H); Q (H + 1, dim_x, dim_x);
// R (H, dim_u, dim_u) real; u_prev (B, dim_u) or null. Outputs row-major:
// P (B, n, n), q, lb, ub (B, n), w (B, H + 1, dim_x), M (B, H + 1, dim_x, n).
//
// Work per lane, FMA = 2 flops (kernels/condense.py::condense_small_work):
// at the flagship's dim_x 4, H 10, dim_u 1, two monomials, ~25 kFLOP against
// ~4.8 KB read and written, of which M is 3.5 KB. The bound is the bytes:
// at B 131,072, 0.63 GB, 0.19 ms at 3.35 TB/s, against 0.05 ms of float32
// FMA at 67 TFLOP/s. Full float32 FMA throughout; no tensor cores, no TF32.
//
// Design. A team of W threads, W the power of two >= max(dim_x, n), does one
// lane; a block of 128 threads holds 128 / W lanes (fewer threads at a small
// B, never under one warp). The shared constants A, N, Q, X_bm, U_bm and R
// sit in shared memory once a block, zero-padded to DX, the power of two
// >= dim_x, so the padded rows and columns stay zero in every product.
//   - Phase 1, thread x < dim_x: row x of A_t, of B_t and Delta_t, and
//     w_{t+1}[x], into the team's slots of shared memory.
//   - Phase 2, thread j < n: column j of M_{t+1} in registers (A_t from
//     shared memory, read as broadcasts), then column j of
//     G = Q_{t+1}^H M_{t+1} into shared memory and its share of q,
//     Re(G[:, j]^H e); after a __syncwarp column j of P accumulates
//     Re(G[:, r]^H M[:, j]) over the rows r. Columns of step t and later are
//     still zero, so the work of step t covers the first (t + 1) dim_u
//     columns only.
// Two __syncwarp a step; w is double-buffered. Thread j writes column j of
// M, P, q, lb and ub, so a team's stores of a row are contiguous. A team
// past the end of the batch redoes the last lane and stores nothing, so
// every thread reaches every __syncwarp.

#include <cuda_runtime.h>

#include <algorithm>

constexpr int kCondenseMaxLm = 16;
constexpr int kCondenseMaxDimU = 16;

// the call's sizes, strides (elements) and the monomials' exponents; passed
// by value, mirrored by kernels/condense.py::_Args. Outside the anonymous
// namespace: the C entry point takes it, and keeps its external linkage
struct CondenseArgs {
  long long sA[2], sN[3], sX[3], sU[3], sx0[2], sXbm[2], sUbm[2], sQ[3], sR[3], sup[2];
  int B, dim_x, H, dim_u, Lm, slew;
  float sat, du;
  unsigned char powers[kCondenseMaxLm * kCondenseMaxDimU];  // (Lm, dim_u), row-major
};

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSmem = 232448;  // the opt-in maximum a block of sm_90

__host__ __device__ constexpr int up4(int v) { return (v + 3) & ~3; }

// float offsets into dynamic shared memory: the block's constants, then one
// slice of `team` floats per team
struct Layout {
  int A, N, Q, Xbm, Ubm, R, block;
  int X, U, F, DF, W, At, Bt, G, team;
};

__host__ __device__ inline Layout layout(int DX, int W, int H, int du, int Lm) {
  Layout L{};
  int o = 0;
  L.A = o;   o += up4(2 * DX * DX);
  L.N = o;   o += up4(2 * DX * Lm * DX);
  L.Q = o;   o += up4(2 * (H + 1) * DX * DX);
  L.Xbm = o; o += up4(2 * (H + 1) * DX);
  L.Ubm = o; o += up4(H * du);
  L.R = o;   o += up4(H * du * du);
  L.block = o;
  o = 0;
  L.X = o;  o += up4(2 * H * DX);
  L.U = o;  o += up4(H * du);
  L.F = o;  o += up4(H * Lm);
  L.DF = o; o += up4(H * du * Lm);
  L.W = o;  o += up4(2 * 2 * DX);
  L.At = o; o += up4(2 * DX * DX);
  L.Bt = o; o += up4(2 * DX * du);
  L.G = o;  o += up4(2 * DX * W);
  L.team = o;
  return L;
}

__device__ __forceinline__ float2 czero() { return make_float2(0.0f, 0.0f); }

// acc + a b
__device__ __forceinline__ float2 cfma(float2 a, float2 b, float2 acc) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
  return acc;
}

// acc + conj(a) b
__device__ __forceinline__ float2 cjfma(float2 a, float2 b, float2 acc) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(-a.y, b.x, acc.y);
  return acc;
}

// NaN-propagating max and min, as torch.maximum / torch.minimum
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}

template <int DX, int W>
__global__ void __launch_bounds__(kThreads)
condense_small_kernel(const float2* __restrict__ A_in, const float2* __restrict__ N_in,
                      const float2* __restrict__ X_in, const float* __restrict__ U_in,
                      const float2* __restrict__ x0_in, const float2* __restrict__ Xbm_in,
                      const float* __restrict__ Ubm_in, const float2* __restrict__ Q_in,
                      const float* __restrict__ R_in, const float* __restrict__ up_in,
                      float* __restrict__ P_out, float* __restrict__ q_out,
                      float* __restrict__ lb_out, float* __restrict__ ub_out,
                      float2* __restrict__ w_out, float2* __restrict__ M_out,
                      const CondenseArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int dx = a.dim_x, H = a.H, du = a.dim_u, Lm = a.Lm, n = H * du;
  const Layout L = layout(DX, W, H, du, Lm);
  const int teams = blockDim.x / W;
  const int team = threadIdx.x / W;
  const int r = threadIdx.x % W;
  const int b_team = blockIdx.x * teams + team;
  const bool store = b_team < a.B;
  const long long b = store ? b_team : a.B - 1;

  float2* sA = reinterpret_cast<float2*>(smem + L.A);
  float2* sN = reinterpret_cast<float2*>(smem + L.N);
  float2* sQ = reinterpret_cast<float2*>(smem + L.Q);
  float2* sXbm = reinterpret_cast<float2*>(smem + L.Xbm);
  float* sUbm = smem + L.Ubm;
  float* sR = smem + L.R;
  float* tm = smem + L.block + team * L.team;
  float2* sX = reinterpret_cast<float2*>(tm + L.X);
  float* sU = tm + L.U;
  float* sF = tm + L.F;
  float* sDF = tm + L.DF;
  float2* sW = reinterpret_cast<float2*>(tm + L.W);
  float2* sAt = reinterpret_cast<float2*>(tm + L.At);
  float2* sBt = reinterpret_cast<float2*>(tm + L.Bt);
  float2* sG = reinterpret_cast<float2*>(tm + L.G);

  // the block's constants, zero-padded to DX: A [x][y], N [x][l][y],
  // Q [t][x][y], X_bm [t][y], U_bm [t][i], R [t][i][j]
  for (int k = threadIdx.x; k < DX * DX; k += blockDim.x) {
    const int x = k / DX, y = k % DX;
    sA[k] = (x < dx && y < dx) ? A_in[x * a.sA[0] + y * a.sA[1]] : czero();
  }
  for (int k = threadIdx.x; k < DX * Lm * DX; k += blockDim.x) {
    const int x = k / (Lm * DX), l = (k / DX) % Lm, y = k % DX;
    sN[k] = (x < dx && y < dx) ? N_in[x * a.sN[0] + l * a.sN[1] + y * a.sN[2]] : czero();
  }
  for (int k = threadIdx.x; k < (H + 1) * DX * DX; k += blockDim.x) {
    const int t = k / (DX * DX), x = (k / DX) % DX, y = k % DX;
    sQ[k] = (x < dx && y < dx) ? Q_in[t * a.sQ[0] + x * a.sQ[1] + y * a.sQ[2]] : czero();
  }
  for (int k = threadIdx.x; k < (H + 1) * DX; k += blockDim.x) {
    const int t = k / DX, y = k % DX;
    sXbm[k] = y < dx ? Xbm_in[y * a.sXbm[0] + t * a.sXbm[1]] : czero();
  }
  for (int k = threadIdx.x; k < H * du; k += blockDim.x) {
    sUbm[k] = Ubm_in[(k % du) * a.sUbm[0] + (k / du) * a.sUbm[1]];
  }
  for (int k = threadIdx.x; k < H * du * du; k += blockDim.x) {
    const int t = k / (du * du), i = (k / du) % du, j = k % du;
    sR[k] = R_in[t * a.sR[0] + i * a.sR[1] + j * a.sR[2]];
  }
  // the team's lane: X [t][y], U [t][i], w_0 = x_init; A_t and B_t rows
  // past dim_x stay zero
  for (int k = r; k < H * DX; k += W) {
    const int t = k / DX, y = k % DX;
    sX[k] = y < dx ? X_in[b * a.sX[0] + y * a.sX[1] + t * a.sX[2]] : czero();
  }
  for (int k = r; k < H * du; k += W) {
    sU[k] = U_in[b * a.sU[0] + (k % du) * a.sU[1] + (k / du) * a.sU[2]];
  }
  for (int k = r; k < 2 * DX; k += W) {
    sW[k] = (k < dx) ? x0_in[b * a.sx0[0] + k * a.sx0[1]] : czero();
  }
  for (int k = r; k < DX * DX; k += W) sAt[k] = czero();
  for (int k = r; k < DX * du; k += W) sBt[k] = czero();
  __syncthreads();

  // f_l(u_t) into F [t][l] and d f_l / d u_i (u_t) into DF [t][i][l], each
  // as lift_controls forms it: the factors in order, times the exponent
  for (int k = r; k < H * Lm * (1 + du); k += W) {
    const int t = k / (Lm * (1 + du)), rest = k % (Lm * (1 + du));
    const int i = rest / Lm - 1, l = rest % Lm;  // i = -1: f itself
    const float* u = sU + t * du;
    float acc = 0.0f;
    bool any = false, zero = false;
    for (int v = 0; v < du; ++v) {
      int p = a.powers[l * du + v] - (v == i ? 1 : 0);
      if (p < 0) zero = true;
      for (; p > 0; --p) {
        acc = any ? acc * u[v] : u[v];
        any = true;
      }
    }
    const float c = i < 0 ? 1.0f : (float)a.powers[l * du + i];
    const float val = zero ? 0.0f : (any ? (c == 1.0f ? acc : acc * c) : c);
    if (i < 0) {
      sF[t * Lm + l] = val;
    } else {
      sDF[(t * du + i) * Lm + l] = val;
    }
  }
  if (store && r < dx) w_out[(b * (H + 1)) * dx + r] = sW[r];
  if (store && r < n) {
    for (int x = 0; x < dx; ++x) M_out[((b * (H + 1)) * dx + x) * n + r] = czero();
  }
  __syncwarp();

  float2 mc[DX];   // column r of M_t
  float pacc[W];   // column r of the state cost's P
  float qacc = 0.0f;
#pragma unroll
  for (int x = 0; x < DX; ++x) mc[x] = czero();
#pragma unroll
  for (int k = 0; k < W; ++k) pacc[k] = 0.0f;

  for (int t = 0; t < H; ++t) {
    const float2* wt = sW + (t & 1) * DX;
    float2* wn = sW + ((t + 1) & 1) * DX;
    if (r < dx) {
      // phase 1: row r of A_t, B_t and Delta_t, and w_{t+1}[r]
      float2 at[DX];
#pragma unroll
      for (int y = 0; y < DX; ++y) at[y] = czero();
      float2* bt = sBt + r * du;
      for (int i = 0; i < du; ++i) bt[i] = czero();
      const float2* xt = sX + t * DX;
      for (int l = 0; l < Lm; ++l) {
        const float f = sF[t * Lm + l];
        const float2* nrow = sN + (r * Lm + l) * DX;
        float2 nx = czero();  // (N x_t)[r, l]
#pragma unroll
        for (int y = 0; y < DX; ++y) {
          const float2 v = nrow[y];
          at[y].x = fmaf(f, v.x, at[y].x);
          at[y].y = fmaf(f, v.y, at[y].y);
          nx = cfma(v, xt[y], nx);
        }
        for (int i = 0; i < du; ++i) {
          const float d = sDF[(t * du + i) * Lm + l];
          bt[i].x = fmaf(nx.x, d, bt[i].x);
          bt[i].y = fmaf(nx.y, d, bt[i].y);
        }
      }
      float2 bu = czero();  // B_t u_t, so Delta_t = -bu
      for (int i = 0; i < du; ++i) {
        const float u = sU[t * du + i];
        bu.x = fmaf(bt[i].x, u, bu.x);
        bu.y = fmaf(bt[i].y, u, bu.y);
      }
      float2 aw = czero();
#pragma unroll
      for (int y = 0; y < DX; ++y) {
        const float2 a0 = sA[r * DX + y];
        at[y] = make_float2(a0.x + at[y].x, a0.y + at[y].y);
        sAt[r * DX + y] = at[y];
        aw = cfma(at[y], wt[y], aw);
      }
      const float2 wnew = make_float2(aw.x - bu.x, aw.y - bu.y);
      wn[r] = wnew;
      if (store) w_out[(b * (H + 1) + t + 1) * dx + r] = wnew;
    }
    __syncwarp();

    // phase 2: column r of M_{t+1}, of G = Q_{t+1}^H M_{t+1}, its share of q
    const int c0 = t * du, lim = c0 + du;
    if (r < lim) {
      if (r < c0) {
        float2 nm[DX];
#pragma unroll
        for (int x = 0; x < DX; ++x) {
          float2 acc = czero();
#pragma unroll
          for (int y = 0; y < DX; ++y) acc = cfma(sAt[x * DX + y], mc[y], acc);
          nm[x] = acc;
        }
#pragma unroll
        for (int x = 0; x < DX; ++x) mc[x] = nm[x];
      } else {
        // M_t's column is zero: A_t M_t adds nothing to B_t's column
#pragma unroll
        for (int x = 0; x < DX; ++x) mc[x] = sBt[x * du + (r - c0)];
      }
      const float2* Qt = sQ + (t + 1) * DX * DX;
      const float2* xb = sXbm + (t + 1) * DX;
      float qa = 0.0f;
#pragma unroll
      for (int y = 0; y < DX; ++y) {
        float2 g = czero();
#pragma unroll
        for (int x = 0; x < DX; ++x) g = cjfma(Qt[x * DX + y], mc[x], g);
        sG[y * W + r] = g;
        const float2 wv = wn[y], xv = xb[y];
        qa = fmaf(g.x, wv.x - xv.x, qa);
        qa = fmaf(g.y, wv.y - xv.y, qa);
      }
      qacc += qa;
    }
    __syncwarp();
    if (r < lim) {
      // P[k, r] += Re(G[:, k]^H M[:, r]) over the nonzero columns k
#pragma unroll
      for (int k = 0; k < W; ++k) {
        if (k < lim) {
          float acc = 0.0f;
#pragma unroll
          for (int y = 0; y < DX; ++y) {
            const float2 g = sG[y * W + k];
            acc = fmaf(g.x, mc[y].x, acc);
            acc = fmaf(g.y, mc[y].y, acc);
          }
          pacc[k] += acc;
        }
      }
    }
    if (store && r < n) {
      float2* Mt = M_out + ((b * (H + 1) + t + 1) * dx) * n + r;
#pragma unroll
      for (int x = 0; x < DX; ++x) {
        if (x < dx) Mt[(long long)x * n] = mc[x];
      }
    }
  }

  if (store && r < n) {
    // the control cost: P += blockdiag(R_t), q -= blockdiag(R_t) vec(U_bm)
    const int t = r / du, i = r % du;
    float ru = 0.0f;
    for (int j = 0; j < du; ++j) ru = fmaf(sR[(t * du + i) * du + j], sUbm[t * du + j], ru);
    q_out[b * n + r] = qacc - ru;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if (k < n) {
        const float pu = (k / du == t) ? sR[(t * du + k % du) * du + i] : 0.0f;
        P_out[(b * n + k) * n + r] = pacc[k] + pu;
      }
    }
    // saturation, and the first step's slew box around u_prev
    float lo = -a.sat, hi = a.sat;
    if (a.slew && r < du) {
      const float u = up_in[b * a.sup[0] + r * a.sup[1]];
      lo = nan_max(lo, u - a.du);
      hi = nan_min(hi, u + a.du);
    }
    lb_out[b * n + r] = lo;
    ub_out[b * n + r] = hi;
  }
}

__host__ __device__ constexpr int pow2_at_least(int v) {
  return v <= 1 ? 1 : v <= 2 ? 2 : v <= 4 ? 4 : v <= 8 ? 8 : 16;
}

template <int DX, int W>
cudaError_t launch(const float2* A, const float2* N, const float2* X, const float* U,
                   const float2* x0, const float2* Xbm, const float* Ubm, const float2* Q,
                   const float* R, const float* up, float* P, float* q, float* lb, float* ub,
                   float2* w, float2* M, const CondenseArgs& a, cudaStream_t stream) {
  // opted into once, at the most a block may take, so a launch makes no
  // other API call and can be captured in a CUDA graph
  static const cudaError_t attr = cudaFuncSetAttribute(
      condense_small_kernel<DX, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const int threads = std::min(kThreads, std::max(32, (W * a.B + 31) / 32 * 32));
  const int teams = threads / W;
  const Layout L = layout(DX, W, a.H, a.dim_u, a.Lm);
  const size_t smem = sizeof(float) * (size_t)(L.block + teams * L.team);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  const int blocks = (a.B + teams - 1) / teams;
  condense_small_kernel<DX, W><<<blocks, threads, smem, stream>>>(
      A, N, X, U, x0, Xbm, Ubm, Q, R, up, P, q, lb, ub, w, M, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mpc4q_condense_small(const float2* A, const float2* N, const float2* X,
                                    const float* U, const float2* x0, const float2* Xbm,
                                    const float* Ubm, const float2* Q, const float* R,
                                    const float* up, float* P, float* q, float* lb, float* ub,
                                    float2* w, float2* M, const CondenseArgs* args,
                                    void* stream) {
  const CondenseArgs& a = *args;
  if (a.B <= 0) return cudaSuccess;
  const int n = a.H * a.dim_u;
  if (a.dim_x < 1 || a.dim_x > 16 || n < 1 || n > 16 || a.Lm < 1 || a.Lm > kCondenseMaxLm ||
      a.dim_u > kCondenseMaxDimU) {
    return cudaErrorInvalidValue;
  }
  const int dx = pow2_at_least(a.dim_x);
  const int tw = pow2_at_least(std::max(a.dim_x, n));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CASE(DD, WW)                                                                   \
  if (dx == DD && tw == WW)                                                            \
    return launch<DD, WW>(A, N, X, U, x0, Xbm, Ubm, Q, R, up, P, q, lb, ub, w, M, a, s);
  CASE(1, 1) CASE(1, 2) CASE(1, 4) CASE(1, 8) CASE(1, 16)
  CASE(2, 2) CASE(2, 4) CASE(2, 8) CASE(2, 16)
  CASE(4, 4) CASE(4, 8) CASE(4, 16)
  CASE(8, 8) CASE(8, 16)
  CASE(16, 16)
#undef CASE
  return cudaErrorInvalidValue;
}
