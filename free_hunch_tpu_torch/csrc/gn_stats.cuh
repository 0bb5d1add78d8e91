// What K1 (csrc/groupnorm.cu) and K2 (csrc/gn_quant.cu) share, for Hopper
// (sm_90a): the per-(sample, group) GroupNorm statistics of a channels-last
// (N, S, C) tensor, the streaming loop over its rows, and the normalise +
// affine + SiLU chain each element goes through.
//
// Replaces the statistics passes of two TPU kernels: _stats_kernel of
// free_hunch_tpu/ops/pallas_groupnorm.py (:70-85) and of
// free_hunch_tpu/ops/pallas_gn_quant.py (:71-95). Both sum x and x^2 and
// take E[x^2] - E[x]^2, which loses every digit when |mean| >> std; here the
// variance is CENTRED: per-thread Welford accumulation, Chan merges between
// threads, chunks and channels.
//
// Bound: device-memory bytes (one read of x, ~7 flops per element). Every
// pass is a grid (P chunks, N samples) of blocks of (C / V, TY) threads
// (ops/groupnorm.py::gn_plan sizes it for the device's SM count): each
// thread owns V channels (one 16-byte vector: 8 bf16 or 4 f32; a warp reads
// 512 contiguous bytes) and walks its chunk's rows TY apart, with
// kUnroll = 4 rows' loads issued before the first is used, so every thread
// keeps 64 bytes in flight.
//   gn_stats_kernel<T, MINMAX>: Welford (mean, M2) per channel in
//     registers, merged over the block's rows, then over the group's
//     channels in shared memory; one (mean, M2) partial per (sample, chunk,
//     group). With MINMAX (K2 only; K1 does not pay for it) it also keeps
//     the min and max of x per channel and writes one (min, max) per
//     (sample, chunk, channel): K2's per-sample abs-max is taken from them.
//   merge_groups: one block per sample merges the P chunk partials of each
//     group in a fixed order into (mean, rstd) per (sample, group).
// The one-launch path of small calls (csrc/gn_cluster.cuh) walks its chunks
// with the same welford_row and block_partials.
// No atomics, so every result is bitwise deterministic. Counts are carried
// as f32: exact while S * C / G < 2^24 (the wrappers check it).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 4;  // rows whose loads each thread issues together

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void cvt(const uint4& raw, float* out) {
    out[0] = __uint_as_float(raw.x);
    out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z);
    out[3] = __uint_as_float(raw.w);
  }
  __device__ __forceinline__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  // bf16 -> f32 is exact: the bf16 bits are the f32's upper half
  __device__ __forceinline__ static void cvt(const uint4& raw, float* out) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* in) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Chan et al.: merge partial (n_b, mean_b, m2_b) into (n_a, mean_a, m2_a).
__device__ __forceinline__ void chan_merge(float& n_a, float& mean_a, float& m2_a,
                                           float n_b, float mean_b, float m2_b) {
  if (n_b == 0.f) return;
  if (n_a == 0.f) {
    n_a = n_b;
    mean_a = mean_b;
    m2_a = m2_b;
    return;
  }
  const float n = n_a + n_b;
  const float delta = mean_b - mean_a;
  const float wb = n_b / n;
  mean_a += delta * wb;
  m2_a += m2_b + delta * delta * n_a * wb;
  n_a = n;
}

// The chain every element goes through, written with explicit roundings so
// that every pass (and K2's scale from the extremes) computes it alike:
// t = (x - mean) * rstd * gamma + beta, then SiLU. The plain versions take
// t * (1 / (1 + exp(-t))); here __expf and an approximate division (within
// 2 f32 ulps, inside K1's and K2's checks). The accurate form left the
// streaming passes instruction-bound on an H100: K2's quantise pass at 1.75
// TB/s on its read and write against 2.32 TB/s, K1's apply at 2.19 against
// 2.84 TB/s (chip_smoke.py --gn; PERF.md section 6).
__device__ __forceinline__ float gn_affine(float v, float mu, float rs, float gm, float bt) {
  return __fmaf_rn(__fmul_rn(__fsub_rn(v, mu), rs), gm, bt);
}

__device__ __forceinline__ float silu(float t) { return __fdividef(t, 1.f + __expf(-t)); }

// The constants of the chain for one thread's V channels c0 .. c0+V-1 of
// one sample; stats points at the sample's G (mean, rstd), gamma and beta
// at its row ((C,) for K1, row n of (N, C) for K2). 4 V registers.
template <int V>
struct Chain {
  float mu[V], rs[V], gm[V], bt[V];
  __device__ __forceinline__ void init(const float2* stats, const float* gamma,
                                       const float* beta, int C, int G, int c0) {
    const int cg = C / G;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float2 st = stats[(c0 + j) / cg];
      mu[j] = st.x;
      rs[j] = st.y;
      gm[j] = gamma[c0 + j];
      bt[j] = beta[c0 + j];
    }
  }
  __device__ __forceinline__ float affine(float v, int j) const {
    return gn_affine(v, mu[j], rs[j], gm[j], bt[j]);
  }
};

// One row's V values into a thread's Welford state (and extremes).
template <int V, bool MINMAX>
__device__ __forceinline__ void welford_row(const float* v, float* mean, float* m2, float* lo,
                                            float* hi, int& cnt) {
  ++cnt;
  const float inv = 1.f / (float)cnt;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float d = v[j] - mean[j];
    mean[j] += d * inv;
    m2[j] += d * (v[j] - mean[j]);
    if (MINMAX) {
      lo[j] = fminf(lo[j], v[j]);
      hi[j] = fmaxf(hi[j], v[j]);
    }
  }
}

// Shared memory of block_partials: (MINMAX ? 4 : 2) * TY * C + TY floats.
__host__ __device__ constexpr size_t partials_floats(bool minmax, int ty, int C) {
  return (size_t)(minmax ? 4 : 2) * ty * C + ty;
}

// A block of (C / V, TY) threads that has walked the nr rows of one chunk:
// merge the TY row partials of each channel in ty order, then the group's
// channels, into groups_out[g] = (mean, M2) of the chunk's group g; with
// MINMAX also extrema_out[c] = (min, max) of channel c.
template <int V, bool MINMAX>
__device__ __forceinline__ void block_partials(const float* mean, const float* m2,
                                               const float* lo, const float* hi, int cnt,
                                               float* smem, int C, int G, int nr,
                                               float2* groups_out, float2* extrema_out) {
  const int tx = threadIdx.x, ty = threadIdx.y, TX = blockDim.x, TY = blockDim.y;
  const int c0 = tx * V;
  float* s_mean = smem;
  float* s_m2 = smem + TY * C;
  float* s_cnt = smem + 2 * TY * C;
  float* s_lo = s_cnt + TY;
  float* s_hi = s_lo + TY * C;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s_mean[ty * C + c0 + j] = mean[j];
    s_m2[ty * C + c0 + j] = m2[j];
    if (MINMAX) {
      s_lo[ty * C + c0 + j] = lo[j];
      s_hi[ty * C + c0 + j] = hi[j];
    }
  }
  if (tx == 0) s_cnt[ty] = (float)cnt;
  __syncthreads();

  // per channel: merge the TY row-partials in ty order into row 0
  const int tid = ty * TX + tx, nthreads = TX * TY;
  for (int c = tid; c < C; c += nthreads) {
    float na = s_cnt[0], ma = s_mean[c], qa = s_m2[c];
    for (int k = 1; k < TY; ++k)
      chan_merge(na, ma, qa, s_cnt[k], s_mean[k * C + c], s_m2[k * C + c]);
    s_mean[c] = ma;
    s_m2[c] = qa;
    if (MINMAX) {
      float a = s_lo[c], b = s_hi[c];
      for (int k = 1; k < TY; ++k) {
        a = fminf(a, s_lo[k * C + c]);
        b = fmaxf(b, s_hi[k * C + c]);
      }
      extrema_out[c] = make_float2(a, b);
    }
  }
  __syncthreads();

  // per group: the cg channels carry equal counts (the chunk's rows), so the
  // merge is the mean of means plus the spread of the channel means
  const int cg = C / G;
  for (int g = tid; g < G; g += nthreads) {
    float mg = 0.f;
    for (int j = 0; j < cg; ++j) mg += s_mean[g * cg + j];
    mg /= (float)cg;
    float q = 0.f;
    for (int j = 0; j < cg; ++j) {
      const float d = s_mean[g * cg + j] - mg;
      q += s_m2[g * cg + j] + (float)nr * d * d;
    }
    groups_out[g] = make_float2(mg, q);
  }
}

// blockDim = (C / V, TY); grid = (P, N). Dynamic shared memory:
// partials_floats(MINMAX, TY, C) floats. Reads x once.
template <typename T, bool MINMAX>
__global__ void __launch_bounds__(1024)
    gn_stats_kernel(const T* __restrict__ x, float2* __restrict__ partial,
                    float2* __restrict__ extrema, int S, int C, int G, int rows_per_chunk) {
  constexpr int V = Vec<T>::N;
  extern __shared__ float smem[];
  const int n = blockIdx.y, p = blockIdx.x, P = gridDim.x;
  const int ty = threadIdx.y, TY = blockDim.y;
  const int r0 = p * rows_per_chunk;
  const int r1 = min(S, r0 + rows_per_chunk);
  const T* xn = x + (size_t)n * S * C + threadIdx.x * V;

  float mean[V], m2[V], lo[V], hi[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mean[j] = 0.f;
    m2[j] = 0.f;
    lo[j] = INFINITY;
    hi[j] = -INFINITY;
  }
  int cnt = 0;
  for (int r = r0 + ty; r < r1; r += kUnroll * TY) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (r + u * TY < r1) raw[u] = load16(xn + (size_t)(r + u * TY) * C);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * TY >= r1) break;
      float v[V];
      Vec<T>::cvt(raw[u], v);
      welford_row<V, MINMAX>(v, mean, m2, lo, hi, cnt);
    }
  }
  block_partials<V, MINMAX>(mean, m2, lo, hi, cnt, smem, C, G, r1 - r0,
                            partial + ((size_t)n * P + p) * G,
                            MINMAX ? extrema + ((size_t)n * P + p) * C : nullptr);
}

// Inside a block of (L lanes, G) threads for sample n: merge the P chunk
// partials of each group, lane l taking chunks l, l + L, ... and lane 0 the
// L lane results in order, into s_stats[g] = (mean, rstd). scratch: 3 * L * G
// floats of shared memory. Ends with __syncthreads().
__device__ __forceinline__ void merge_groups(const float2* __restrict__ partial, float* scratch,
                                             float2* s_stats, int n, int S, int G, int P,
                                             int rows_per_chunk, int cg, float eps) {
  const int l = threadIdx.x, L = blockDim.x, g = threadIdx.y;
  float na = 0.f, ma = 0.f, qa = 0.f;
  for (int p = l; p < P; p += L) {
    const float2 v = partial[((size_t)n * P + p) * G + g];
    const int rows = min(rows_per_chunk, S - p * rows_per_chunk);
    chan_merge(na, ma, qa, (float)rows * (float)cg, v.x, v.y);
  }
  float* s = scratch + (g * L + l) * 3;
  s[0] = na;
  s[1] = ma;
  s[2] = qa;
  __syncthreads();
  if (l == 0) {
    for (int k = 1; k < L; ++k) {
      const float* t = scratch + (g * L + k) * 3;
      chan_merge(na, ma, qa, t[0], t[1], t[2]);
    }
    const float var = qa / na;
    s_stats[g] = make_float2(ma, 1.f / sqrtf(var + eps));
  }
  __syncthreads();
}

// K2's abs-max from the extremes is exact where it reaches kLobe, which is
// above max |SiLU(t)| over t < 0, 0.278465 (at t = -1.2785).
constexpr float kLobe = 0.2785f;

// Max over a block of at most 1024 threads, of any size; every thread gets
// it. red: 1024 floats of shared memory.
__device__ __forceinline__ float block_max(float m, float* red) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  red[tid] = m;
  __syncthreads();
  for (int s = 512; s > 0; s >>= 1) {
    if (tid < s && tid + s < nthreads) red[tid] = fmaxf(red[tid], red[tid + s]);
    __syncthreads();
  }
  const float r = red[0];
  __syncthreads();
  return r;
}

// V int8 codes, stored as one vector of V bytes.
template <int V>
struct Codes;
template <>
struct Codes<8> {
  using type = uint2;
};
template <>
struct Codes<4> {
  using type = uint32_t;
};

// K2's code of y at scale s (rinv = 1 / s): clip(rint(y / s), -127, 127).
// The quotient is y * rinv corrected by one FMA residual step, the
// correctly rounded y / s (barring a tie of the correction itself) at three
// instructions; clipping to integer bounds before the rounding conversion
// gives the same code as after it.
__device__ __forceinline__ int8_t quant_code(float y, float s, float rinv) {
  const float q0 = __fmul_rn(y, rinv);
  const float q = __fmaf_rn(__fmaf_rn(-q0, s, y), rinv, q0);
  return (int8_t)__float2int_rn(fminf(fmaxf(q, -127.f), 127.f));
}

// Set a kernel's dynamic shared-memory limit where it needs more than the
// default 48 KB. Returns the CUDA error code, 0 on success.
template <typename K>
int allow_shared(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace
