// GroupNorm(G)(+SiLU) over a channels-last (N, S, C) tensor, for Hopper (sm_90a).
//
// Replaces the TPU kernel free_hunch_tpu/ops/pallas_groupnorm.py
// (_stats_kernel :70-85, _apply_kernel :88-106). What it computes is that
// file's _reference (:38-59): f32 statistics per (sample, group), then
// (x - mean) * rsqrt(var + eps) * gamma + beta, optional SiLU, cast back to
// the input type. The variance is CENTRED (csrc/gn_stats.cuh): the TPU
// kernel's E[x^2] - E[x]^2 (:93) loses every digit when |mean| >> std.
//
// Bound: device-memory bytes. The arithmetic is ~10 flops per element
// against 2 (bf16) or 4 (f32) bytes moved, far below the H100's ~295
// flop/byte balance point. The least traffic is one read of x and one write
// of y; this design reads x twice (statistics, then apply) and writes y
// once, because the statistics of a whole sample (up to 67 MB at 256 px)
// cannot stay on chip until the apply pass. Three launches, no atomics, so
// every result is bitwise deterministic:
//   1-2. gn_stats_kernel and gn_finalize_kernel (csrc/gn_stats.cuh):
//      (mean, rstd) per (sample, group).
//   3. gn_apply_kernel, grid (P chunks, N samples): streams x once more and
//      writes y.

#include "gn_stats.cuh"

namespace {

// blockDim = (C / V, TY); grid = (P, N).
template <typename T>
__global__ void gn_apply_kernel(const T* __restrict__ x, const float2* __restrict__ stats,
                                const float* __restrict__ gamma, const float* __restrict__ beta,
                                T* __restrict__ y, int S, int C, int G, int rows_per_chunk,
                                int apply_silu) {
  constexpr int V = Vec<T>::N;
  const int n = blockIdx.y, p = blockIdx.x;
  const int tx = threadIdx.x, ty = threadIdx.y, TY = blockDim.y;
  const int c0 = tx * V;
  const int cg = C / G;
  float mu[V], rs[V], gm[V], bt[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = c0 + j;
    const float2 st = stats[(size_t)n * G + c / cg];
    mu[j] = st.x;
    rs[j] = st.y;
    gm[j] = gamma[c];
    bt[j] = beta[c];
  }
  const int r0 = p * rows_per_chunk;
  const int r1 = min(S, r0 + rows_per_chunk);
  const size_t base = (size_t)n * S * C;
  for (int r = r0 + ty; r < r1; r += TY) {
    float v[V];
    Vec<T>::load(x + base + (size_t)r * C + c0, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float t = (v[j] - mu[j]) * rs[j];
      t = t * gm[j] + bt[j];
      if (apply_silu) t = t * (1.f / (1.f + expf(-t)));
      v[j] = t;
    }
    Vec<T>::store(y + base + (size_t)r * C + c0, v);
  }
}

template <typename T>
int launch(const void* x, void* y, const float* gamma, const float* beta, void* partial,
           void* stats, int N, int S, int C, int G, int rows_per_chunk, int P, int ty,
           int lanes, float eps, int apply_silu, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const int err = launch_gn_stats<T>(x, partial, stats, N, S, C, G, rows_per_chunk, P, ty,
                                     lanes, eps, stream);
  if (err != 0) return err;
  gn_apply_kernel<T><<<dim3(P, N), dim3(C / V, ty), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float2*>(stats), gamma, beta,
      static_cast<T*>(y), S, C, G, rows_per_chunk, apply_silu);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. The caller (ops/groupnorm.py)
// validates shapes, types, contiguity and alignment, allocates y and the
// scratch buffers (partial: N * P * G float2, stats: N * G float2) and
// chooses the chunking. Returns the first CUDA error code, 0 on success.
extern "C" int fh_groupnorm_forward(const void* x, void* y, const float* gamma,
                                    const float* beta, void* partial, void* stats, int N,
                                    int S, int C, int G, int rows_per_chunk, int P, int ty,
                                    int lanes, float eps, int apply_silu, int is_bf16,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, y, gamma, beta, partial, stats, N, S, C, G,
                                 rows_per_chunk, P, ty, lanes, eps, apply_silu, s);
  return launch<float>(x, y, gamma, beta, partial, stats, N, S, C, G, rows_per_chunk, P, ty,
                       lanes, eps, apply_silu, s);
}
