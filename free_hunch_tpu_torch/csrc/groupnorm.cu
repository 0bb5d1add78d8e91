// GroupNorm(G)(+SiLU) over a channels-last (N, S, C) tensor, for Hopper (sm_90a).
//
// Replaces the TPU kernel free_hunch_tpu/ops/pallas_groupnorm.py
// (_stats_kernel :70-85, _apply_kernel :88-106). What it computes is that
// file's _reference (:38-59): f32 statistics per (sample, group), then
// (x - mean) * rsqrt(var + eps) * gamma + beta, optional SiLU, cast back to
// the input type. The variance is CENTRED (csrc/gn_stats.cuh): the TPU
// kernel's E[x^2] - E[x]^2 (:93) loses every digit when |mean| >> std.
//
// Bound: device-memory bytes. The arithmetic is ~20 instructions per
// element against 4 (bf16) or 8 (f32) bytes moved, below what the SMs issue
// at the memory's rate. The least traffic is one read of x and one write of
// y; this design reads x twice (statistics, then apply) and writes y once,
// because the statistics of a whole sample (up to 67 MB at 256 px) cannot
// stay on chip until the apply pass. A call whose sample fits a cluster's
// shared memory (the 8-32 px calls) takes the one-launch path of
// csrc/gn_cluster.cuh instead, which reads x once. The two-pass path: three
// launches, no atomics, so every result is bitwise deterministic:
//   1. gn_stats_kernel<T, false> (csrc/gn_stats.cuh): (mean, M2) partials
//      per (sample, chunk, group); reads x once.
//   2. gn_finalize_kernel, one block per sample: (mean, rstd) per group.
//   3. gn_apply_kernel, grid (P chunks, N samples): reads x once more and
//      writes y. Each thread holds its V channels' four constants (32
//      registers at bf16) and issues four rows' 16-byte loads before it
//      uses the first (kUnroll), so a thread keeps 64 bytes in flight; the
//      launch bounds hold it to 64 registers, so four 256-thread blocks fit
//      an SM. Its SiLU takes __expf and an approximate division (within 2
//      f32 ulps, far inside the bf16 rounding of the output; gn_stats.cuh).
// The two-pass path can keep its statistics for the backward: the caller
// then gives them a buffer of their own (the same launches and bytes). The
// input gradient, fh_groupnorm_backward, is csrc/gn_backward.cuh's.
// A height shard (the entries at the end) runs 1 and 2 with (mean, M2,
// count) out, and after the caller's gather gn_apply_merged_kernel, which
// merges the ranks' statistics, each weighted by its own count, in each
// block before it applies them. Shards may differ in size; a shard of no
// rows launches nothing and its partial is (0, 0, 0), which the merge
// skips.

#include "gn_backward.cuh"
#include "gn_cluster.cuh"
#include "gn_stats.cuh"

namespace {

// blockDim = (L, G); grid = (N). Writes (mean, rstd) per (sample, group)
// as float2, or with M2 the (mean, M2, count) of the sample's rows here (a
// height shard) as three floats.
template <bool M2>
__global__ void gn_finalize_kernel(const float2* __restrict__ partial, float* __restrict__ stats,
                                   int S, int G, int P, int rows_per_chunk, int cg, float eps) {
  __shared__ float scratch[3 * 1024];
  __shared__ float2 s_stats[1024];
  merge_groups<M2>(partial, scratch, s_stats, blockIdx.x, S, G, P, rows_per_chunk, cg, eps);
  if (threadIdx.x != 0) return;
  const size_t i = (size_t)blockIdx.x * G + threadIdx.y;
  const float2 st = s_stats[threadIdx.y];
  if (M2) {
    stats[3 * i] = st.x;
    stats[3 * i + 1] = st.y;
    stats[3 * i + 2] = (float)S * (float)cg;
  } else {
    reinterpret_cast<float2*>(stats)[i] = st;
  }
}

// The apply pass of block (p, n): rows of chunk p of sample n through the
// chain with (mean, rstd) per group from stats_n (the sample's G), y written
// in x's type. blockDim = (C / V, TY).
template <typename T, bool SILU>
__device__ __forceinline__ void apply_chunk(const T* __restrict__ x,
                                            const float2* stats_n,
                                            const float* __restrict__ gamma,
                                            const float* __restrict__ beta,
                                            T* __restrict__ y, int S, int C, int G,
                                            int rows_per_chunk) {
  constexpr int V = Vec<T>::N;
  const int n = blockIdx.y, p = blockIdx.x;
  const int ty = threadIdx.y, TY = blockDim.y;
  const int c0 = threadIdx.x * V;
  Chain<V> ch;
  ch.init(stats_n, gamma, beta, C, G, c0);
  const int r0 = p * rows_per_chunk;
  const int r1 = min(S, r0 + rows_per_chunk);
  const size_t base = (size_t)n * S * C + c0;
  for (int r = r0 + ty; r < r1; r += kUnroll * TY) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (r + u * TY < r1) raw[u] = load16(x + base + (size_t)(r + u * TY) * C);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * TY >= r1) break;
      float v[V];
      Vec<T>::cvt(raw[u], v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float t = ch.affine(v[j], j);
        v[j] = SILU ? silu(t) : t;
      }
      Vec<T>::store(y + base + (size_t)(r + u * TY) * C, v);
    }
  }
}

// blockDim = (C / V, TY); grid = (P, N).
template <typename T, bool SILU>
__global__ void __launch_bounds__(1024)
    gn_apply_kernel(const T* __restrict__ x, const float2* __restrict__ stats,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    T* __restrict__ y, int S, int C, int G, int rows_per_chunk) {
  apply_chunk<T, SILU>(x, stats + (size_t)blockIdx.y * G, gamma, beta, y, S, C, G,
                       rows_per_chunk);
}

// The apply pass of a height shard: each block first merges the M ranks'
// (mean, M2, count) of its sample's groups, parts (M, N, G, 3) f32, in rank
// order with chan_merge, each weighted by its own count (as merge_groups
// merges chunks), into (mean, rstd) in shared memory, then applies them.
// blockDim = (C / V, TY); grid = (P, N); dynamic shared memory G float2.
template <typename T, bool SILU>
__global__ void __launch_bounds__(1024)
    gn_apply_merged_kernel(const T* __restrict__ x, const float* __restrict__ parts, int M,
                           float eps, const float* __restrict__ gamma,
                           const float* __restrict__ beta, T* __restrict__ y, int S, int C,
                           int G, int rows_per_chunk) {
  extern __shared__ float2 s_merged[];
  const int n = blockIdx.y, N = gridDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x, nthreads = blockDim.x * blockDim.y;
  for (int g = tid; g < G; g += nthreads) {
    float na = 0.f, ma = 0.f, qa = 0.f;
    for (int r = 0; r < M; ++r) {
      const float* v = parts + (((size_t)r * N + n) * G + g) * 3;
      chan_merge(na, ma, qa, v[2], v[0], v[1]);
    }
    s_merged[g] = make_float2(ma, 1.f / sqrtf(qa / na + eps));
  }
  __syncthreads();
  apply_chunk<T, SILU>(x, s_merged, gamma, beta, y, S, C, G, rows_per_chunk);
}

// The statistics pass and the finalize: (mean, rstd) per (sample, group)
// into stats, or with M2 the (mean, M2, count) of this tensor's rows.
template <typename T, bool M2>
int launch_stats(const void* x, float2* partial, float* stats, int N, int S, int C, int G,
                 int rows, int P, int ty, int lanes, float eps, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const dim3 grid(P, N), block(C / V, ty);
  const size_t smem = partials_floats(false, ty, C) * sizeof(float);
  int err = allow_shared(gn_stats_kernel<T, false>, smem);
  if (err != 0) return err;
  gn_stats_kernel<T, false><<<grid, block, smem, stream>>>(static_cast<const T*>(x), partial,
                                                           nullptr, S, C, G, rows);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  gn_finalize_kernel<M2><<<N, dim3(lanes, G), 0, stream>>>(partial, stats, S, G, P, rows,
                                                           C / G, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_apply(const void* x, void* y, const float2* stats, const float* gamma,
                 const float* beta, int N, int S, int C, int G, int rows, int P, int ty,
                 int apply_silu, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const dim3 grid(P, N), block(C / V, ty);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (apply_silu)
    gn_apply_kernel<T, true><<<grid, block, 0, stream>>>(xt, stats, gamma, beta, yt, S, C, G,
                                                         rows);
  else
    gn_apply_kernel<T, false><<<grid, block, 0, stream>>>(xt, stats, gamma, beta, yt, S, C, G,
                                                          rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, void* y, const float* gamma, const float* beta, float* scratch,
           float* stats_out, int N, int S, int C, int G, int rows, int P, int ty, int lanes,
           float eps, int apply_silu, int cluster, cudaStream_t stream) {
  if (cluster)
    return apply_silu ? launch_cluster<T, 1>(x, gamma, beta, y, nullptr, nullptr, N, S, C, G,
                                             rows, P, ty, eps, 0, stream)
                      : launch_cluster<T, 0>(x, gamma, beta, y, nullptr, nullptr, N, S, C, G,
                                             rows, P, ty, eps, 0, stream);
  float2* partial = reinterpret_cast<float2*>(scratch);
  float2* stats = stats_out ? reinterpret_cast<float2*>(stats_out) : partial + (size_t)N * P * G;
  const int err = launch_stats<T, false>(x, partial, reinterpret_cast<float*>(stats), N, S, C, G,
                                         rows, P, ty, lanes, eps, stream);
  if (err != 0) return err;
  return launch_apply<T>(x, y, stats, gamma, beta, N, S, C, G, rows, P, ty, apply_silu, stream);
}

// The input gradient (csrc/gn_backward.cuh): the cluster path (with the
// forward's statistics, or computing them), or the two launches of the
// two-pass path, which take the forward's statistics.
template <typename T, bool SILU>
int launch_backward(const void* x, const void* dy, void* dx, const float* gamma,
                    const float* beta, const float* stats, float* scratch, int N, int S, int C,
                    int G, int rows, int P, int ty, float eps, int cluster,
                    cudaStream_t stream) {
  const float2* st = reinterpret_cast<const float2*>(stats);
  if (cluster)
    return st ? launch_bwd_cluster<T, SILU, true>(x, dy, st, gamma, beta, dx, N, S, C, G, rows,
                                                  P, ty, eps, stream)
              : launch_bwd_cluster<T, SILU, false>(x, dy, nullptr, gamma, beta, dx, N, S, C, G,
                                                   rows, P, ty, eps, stream);
  if (st == nullptr) return (int)cudaErrorInvalidValue;
  return launch_bwd_two_pass<T, SILU>(x, dy, st, gamma, beta, dx,
                                      reinterpret_cast<float2*>(scratch), N, S, C, G, rows, P,
                                      ty, stream);
}

template <typename T, bool SILU>
int launch_apply_merged(const void* x, void* y, const float* parts, int M, float eps,
                        const float* gamma, const float* beta, int N, int S, int C, int G,
                        int rows, int P, int ty, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  gn_apply_merged_kernel<T, SILU><<<dim3(P, N), dim3(C / V, ty), G * sizeof(float2), stream>>>(
      static_cast<const T*>(x), parts, M, eps, gamma, beta, static_cast<T*>(y), S, C, G, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. The caller (ops/groupnorm.py)
// validates shapes, types, contiguity and alignment, allocates y and, on the
// two-pass path, the scratch buffer (N * P * G + N * G float2: the chunk
// partials, then the statistics) or, where it keeps the statistics for the
// backward, the chunk partials in scratch and the (mean, rstd) per (sample,
// group) in stats (N * G float2), and chooses the path and the chunking
// (gn_plan): `cluster` takes the one-launch path of csrc/gn_cluster.cuh
// (one cluster of P blocks a sample; no scratch, no statistics out).
// Returns the first CUDA error code, 0 on success.
extern "C" int fh_groupnorm_forward(const void* x, void* y, const float* gamma,
                                    const float* beta, float* scratch, float* stats, int N,
                                    int S, int C, int G, int rows_per_chunk, int P, int ty,
                                    int lanes, float eps, int apply_silu, int cluster,
                                    int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();  // so that an error reported here is this call's own
  if (is_bf16)
    return launch<__nv_bfloat16>(x, y, gamma, beta, scratch, stats, N, S, C, G, rows_per_chunk,
                                 P, ty, lanes, eps, apply_silu, cluster, s);
  return launch<float>(x, y, gamma, beta, scratch, stats, N, S, C, G, rows_per_chunk, P, ty,
                       lanes, eps, apply_silu, cluster, s);
}

// The input gradient dx (x's type) of the forward at x for the cotangent
// dy (x's type), csrc/gn_backward.cuh. The caller (ops/groupnorm.py)
// validates the tensors, allocates dx and the scratch and chooses the path
// and the chunking (gn_bwd_plan): `cluster` takes the one-launch path (no
// scratch; stats may be null, and the kernel computes them); else the
// two-pass path, whose scratch holds the chunk sums (N * P * G float2) and
// which needs stats. stats: the forward's (mean, rstd) per (sample, group).
// Returns the first CUDA error code, 0 on success.
extern "C" int fh_groupnorm_backward(const void* x, const void* dy, void* dx, const float* gamma,
                                     const float* beta, const float* stats, float* scratch,
                                     int N, int S, int C, int G, int rows_per_chunk, int P,
                                     int ty, float eps, int apply_silu, int cluster, int is_bf16,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();
  if (is_bf16)
    return apply_silu
               ? launch_backward<__nv_bfloat16, true>(x, dy, dx, gamma, beta, stats, scratch, N,
                                                      S, C, G, rows_per_chunk, P, ty, eps,
                                                      cluster, s)
               : launch_backward<__nv_bfloat16, false>(x, dy, dx, gamma, beta, stats, scratch,
                                                       N, S, C, G, rows_per_chunk, P, ty, eps,
                                                       cluster, s);
  return apply_silu ? launch_backward<float, true>(x, dy, dx, gamma, beta, stats, scratch, N, S,
                                                   C, G, rows_per_chunk, P, ty, eps, cluster, s)
                    : launch_backward<float, false>(x, dy, dx, gamma, beta, stats, scratch, N,
                                                    S, C, G, rows_per_chunk, P, ty, eps,
                                                    cluster, s);
}

// The two halves of the two-pass path, for a height shard of a sample
// (ops/groupnorm.py::groupnorm_silu_sharded), which gathers the shards'
// statistics across ranks between them. The stats entry writes this
// tensor's (mean, M2, count) per (sample, group) into stats (N * G * 3
// f32), from the chunk partials in scratch (N * P * G float2); the apply
// entry takes the M ranks' gathered (mean, M2, count), parts (M, N, G, 3)
// f32, merges them in rank order, weighted by their counts, in each block
// (gn_apply_merged_kernel) and writes y. Shards may hold different numbers
// of rows; the caller launches neither entry for a shard of none (S = 0).
// Returns the first CUDA error code, 0 on success.
extern "C" int fh_groupnorm_stats(const void* x, float* stats, float* scratch, int N, int S,
                                  int C, int G, int rows_per_chunk, int P, int ty, int lanes,
                                  int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();
  float2* partial = reinterpret_cast<float2*>(scratch);
  if (is_bf16)
    return launch_stats<__nv_bfloat16, true>(x, partial, stats, N, S, C, G, rows_per_chunk, P,
                                             ty, lanes, 0.f, s);
  return launch_stats<float, true>(x, partial, stats, N, S, C, G, rows_per_chunk, P, ty, lanes,
                                   0.f, s);
}

extern "C" int fh_groupnorm_apply(const void* x, void* y, const float* parts, int M,
                                  const float* gamma, const float* beta, int N, int S, int C,
                                  int G, int rows_per_chunk, int P, int ty, float eps,
                                  int apply_silu, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();
  if (is_bf16)
    return apply_silu ? launch_apply_merged<__nv_bfloat16, true>(x, y, parts, M, eps, gamma,
                                                                beta, N, S, C, G, rows_per_chunk,
                                                                P, ty, s)
                      : launch_apply_merged<__nv_bfloat16, false>(x, y, parts, M, eps, gamma,
                                                                 beta, N, S, C, G,
                                                                 rows_per_chunk, P, ty, s);
  return apply_silu ? launch_apply_merged<float, true>(x, y, parts, M, eps, gamma, beta, N, S,
                                                       C, G, rows_per_chunk, P, ty, s)
                    : launch_apply_merged<float, false>(x, y, parts, M, eps, gamma, beta, N, S,
                                                        C, G, rows_per_chunk, P, ty, s);
}
