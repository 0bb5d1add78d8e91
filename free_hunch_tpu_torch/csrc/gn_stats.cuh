// Per-(sample, group) GroupNorm statistics over a channels-last (N, S, C)
// tensor, shared by csrc/groupnorm.cu (K1) and csrc/gn_quant.cu (K2).
//
// Replaces the statistics passes of two TPU kernels: _stats_kernel of
// free_hunch_tpu/ops/pallas_groupnorm.py (:70-85) and of
// free_hunch_tpu/ops/pallas_gn_quant.py (:71-95). Both sum x and x^2 and
// take E[x^2] - E[x]^2, which loses every digit when |mean| >> std; here the
// variance is CENTRED: per-thread Welford accumulation, Chan merges between
// threads, chunks and channels.
//
// Bound: device-memory bytes (one read of x, ~5 flops per element). Two
// launches, no atomics, so every result is bitwise deterministic:
//   1. gn_stats_kernel, grid (P chunks, N samples): each block reads whole
//      C-wide rows of its chunk with 16-byte vector loads (consecutive
//      threads on consecutive channels, so a warp reads 512 contiguous
//      bytes), keeps Welford (mean, M2) per channel in registers, merges its
//      rows and then its group's channels in shared memory, and writes one
//      (mean, M2) partial per (sample, chunk, group).
//   2. gn_finalize_kernel, grid (N): 8 lanes per group merge the P chunk
//      partials in a fixed order and write (mean, rstd) per (sample, group).
// Counts are carried as f32: exact while S * C / G < 2^24 (the wrappers
// check it).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
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

// blockDim = (C / V, TY); grid = (P, N). Dynamic shared memory:
// (2 * TY * C + TY) floats.
template <typename T>
__global__ void gn_stats_kernel(const T* __restrict__ x, float2* __restrict__ partial,
                                int S, int C, int G, int rows_per_chunk) {
  constexpr int V = Vec<T>::N;
  extern __shared__ float smem[];
  const int n = blockIdx.y, p = blockIdx.x, P = gridDim.x;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int TX = blockDim.x, TY = blockDim.y;
  const int r0 = p * rows_per_chunk;
  const int r1 = min(S, r0 + rows_per_chunk);
  const int c0 = tx * V;
  const T* xn = x + (size_t)n * S * C;

  float mean[V], m2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mean[j] = 0.f;
    m2[j] = 0.f;
  }
  int cnt = 0;
  for (int r = r0 + ty; r < r1; r += TY) {
    float v[V];
    Vec<T>::load(xn + (size_t)r * C + c0, v);
    ++cnt;
    const float inv = 1.f / (float)cnt;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = v[j] - mean[j];
      mean[j] += d * inv;
      m2[j] += d * (v[j] - mean[j]);
    }
  }

  float* s_mean = smem;
  float* s_m2 = smem + TY * C;
  float* s_cnt = smem + 2 * TY * C;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s_mean[ty * C + c0 + j] = mean[j];
    s_m2[ty * C + c0 + j] = m2[j];
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
  }
  __syncthreads();

  // per group: the cg channels carry equal counts (the chunk's rows), so the
  // merge is the mean of means plus the spread of the channel means
  const int cg = C / G;
  const float nr = (float)(r1 - r0);
  for (int g = tid; g < G; g += nthreads) {
    float mg = 0.f;
    for (int j = 0; j < cg; ++j) mg += s_mean[g * cg + j];
    mg /= (float)cg;
    float q = 0.f;
    for (int j = 0; j < cg; ++j) {
      const float d = s_mean[g * cg + j] - mg;
      q += s_m2[g * cg + j] + nr * d * d;
    }
    partial[((size_t)n * P + p) * G + g] = make_float2(mg, q);
  }
}

// blockDim = (L lanes, G); grid = (N). Dynamic shared memory: 3 * L * G floats.
__global__ void gn_finalize_kernel(const float2* __restrict__ partial, float2* __restrict__ stats,
                                   int S, int G, int P, int rows_per_chunk, int cg, float eps) {
  extern __shared__ float smem[];
  const int n = blockIdx.x;
  const int l = threadIdx.x, L = blockDim.x, g = threadIdx.y;
  float na = 0.f, ma = 0.f, qa = 0.f;
  for (int p = l; p < P; p += L) {
    const float2 v = partial[((size_t)n * P + p) * G + g];
    const int rows = min(rows_per_chunk, S - p * rows_per_chunk);
    chan_merge(na, ma, qa, (float)rows * (float)cg, v.x, v.y);
  }
  float* s = smem + (g * L + l) * 3;
  s[0] = na;
  s[1] = ma;
  s[2] = qa;
  __syncthreads();
  if (l == 0) {
    for (int k = 1; k < L; ++k) {
      const float* t = smem + (g * L + k) * 3;
      chan_merge(na, ma, qa, t[0], t[1], t[2]);
    }
    const float var = qa / na;
    stats[(size_t)n * G + g] = make_float2(ma, 1.f / sqrtf(var + eps));
  }
}

// Launch the two statistics kernels; stats receives (mean, rstd) per
// (sample, group). Returns the first CUDA error code, 0 on success.
template <typename T>
int launch_gn_stats(const void* x, void* partial, void* stats, int N, int S, int C, int G,
                    int rows_per_chunk, int P, int ty, int lanes, float eps,
                    cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const size_t smem = (size_t)(2 * ty * C + ty) * sizeof(float);
  gn_stats_kernel<T><<<dim3(P, N), dim3(C / V, ty), smem, stream>>>(
      static_cast<const T*>(x), static_cast<float2*>(partial), S, C, G, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_finalize_kernel<<<N, dim3(lanes, G), (size_t)3 * lanes * G * sizeof(float), stream>>>(
      static_cast<const float2*>(partial), static_cast<float2*>(stats), S, G, P,
      rows_per_chunk, C / G, eps);
  return (int)cudaGetLastError();
}

}  // namespace
