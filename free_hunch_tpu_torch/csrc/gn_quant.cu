// GroupNorm + per-sample affine + SiLU + per-sample symmetric int8 quantise
// over a channels-last (N, S, C) tensor, for Hopper (sm_90a).
//
// Replaces the TPU kernel free_hunch_tpu/ops/pallas_gn_quant.py: K2a
// _stats_kernel (:71-95, launched at :156), K2b _amax_kernel (:116-128,
// :168) over _normalized_tile (:98-113), K2c _quant_kernel (:131-137,
// :177). What it computes is that file's gn_silu_quant_reference (:50-68):
//   y  = silu((x - mean_g) * rstd_g * gamma[n, c] + beta[n, c])
//   xq = clip(rint(y / s_n), -127, 127),  s_n = max(max|y_n|, 1e-12) / 127
// The affine is per sample: the ResBlock's FiLM epilogue is folded into
// (gamma, beta) by the caller. Rounding is half to even (rintf), as
// jnp.round and torch.round do.
//
// Bound: device-memory bytes. The least traffic is one read of x and one
// int8 write: 805 MB, 0.240 ms at 3.35 TB/s, for the largest call
// (8, 256*256, 512) bf16. The per-sample abs-max must be complete before the
// first code is written, and Hopper's blocks cannot carry a running value
// from one to the next as the TPU's sequential grid does, so the abs-max and
// the codes are separate grids. This design reads x TWICE, not three times:
// the abs-max comes from the statistics pass.
//   - Within a channel, x -> t = (x - mean) * rstd * gamma + beta is
//     monotone (under round-to-nearest too, whatever gamma's sign), so a
//     channel's extreme t lie at its extreme x. |SiLU(t)| grows with t for
//     t >= 0; for t < 0 it never exceeds 0.27846 (at t = -1.2785). So the
//     largest |SiLU(t)| over the per-(chunk, channel) extremes of x is the
//     sample's exact abs-max whenever it is at least kLobe = 0.2785: every
//     value it is compared with is an element's own value, elements with
//     t >= 0 are at most their channel's extreme, and elements with t < 0
//     are below kLobe. Below kLobe the sample is flagged and its abs-max is
//     taken by a full pass over its elements, as before.
// A call whose sample fits a cluster's shared memory (the 8-32 px calls)
// takes the one-launch path of csrc/gn_cluster.cuh instead: x read once,
// the exact abs-max reduced across the cluster. The two-pass path: four
// launches, no host sync, no launch that depends on the data, no atomics,
// so every result is bitwise deterministic:
//   1. gn_stats_kernel<T, true> (csrc/gn_stats.cuh, shared with K1): Welford
//      partials per (sample, chunk, group) and (min, max) of x per (sample,
//      chunk, channel); reads x once.
//   2. gnq_finalize_kernel, grid (Q, N) of (8, G) threads (Q blocks a
//      sample, enough for about two blocks per SM): each merges the group
//      partials into (mean, rstd) in the same fixed order, evaluates
//      |SiLU(t)| at its share of the chunks' extremes with the same device
//      functions the quantise pass applies to an element, four loads in
//      flight a thread, and writes its largest value. (On an H100, one
//      block of 1024 threads a sample took 15-45 µs a call at C >= 512, Q
//      blocks of 1024 threads about 19 µs, Q blocks of 256 threads 7-9 µs.)
//   3. gnq_amax_kernel, grid (P, N): each block reduces the sample's Q
//      values to its candidate and flag, and returns at once for an
//      unflagged sample; for a flagged one it normalises its rows and
//      writes one max|y| per (sample, chunk): x is read again only there.
//   4. gnq_quant_kernel, grid (P, N): s_n from the candidate (a flagged
//      sample's from the P partial maxima), then reads x once more and
//      writes V codes per thread.
// The streaming passes hold each thread's V channels' four constants in
// registers (32 at bf16; the launch bounds keep a thread at 64 registers,
// four 256-thread blocks an SM) and issue kUnroll = 4 rows' 16-byte loads
// before using the first. The quotient y / s_n is q0 = y * (1 / s_n)
// corrected by one FMA residual step, r = y - q0 * s_n, q = q0 + r / s_n:
// that is the correctly rounded quotient the plain version takes (barring
// a tie of the residual step itself), at three instructions instead of
// IEEE division's sequence (quant_code, csrc/gn_stats.cuh). The SiLU takes
// __expf and an approximate division (gn_stats.cuh says why).

#include "gn_cluster.cuh"
#include "gn_stats.cuh"

namespace {

__device__ __forceinline__ float abs_y(float v, float mu, float rs, float gm, float bt) {
  return fabsf(silu(gn_affine(v, mu, rs, gm, bt)));
}

// blockDim = (L, G) with L * G <= 1024; grid = (Q, N). Every block merges
// the sample's group partials (the same fixed order in each, so the same
// result; block 0 writes it), then evaluates |SiLU(t)| at its share of the
// sample's P * C chunk extremes and writes its largest as cand[n, q].
__global__ void gnq_finalize_kernel(const float2* __restrict__ partial,
                                    const float2* __restrict__ extrema,
                                    const float* __restrict__ gamma,
                                    const float* __restrict__ beta, float2* __restrict__ stats,
                                    float* __restrict__ cand, int S, int C, int G, int P,
                                    int rows_per_chunk, float eps) {
  __shared__ float scratch[3 * 1024];
  __shared__ float2 s_stats[1024];
  const int n = blockIdx.y, q = blockIdx.x, Q = gridDim.x;
  merge_groups(partial, scratch, s_stats, n, S, G, P, rows_per_chunk, C / G, eps);
  if (q == 0 && threadIdx.x == 0) stats[(size_t)n * G + threadIdx.y] = s_stats[threadIdx.y];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int cg = C / G;
  const float* gm = gamma + (size_t)n * C;
  const float* bt = beta + (size_t)n * C;
  const float2* ex = extrema + (size_t)n * P * C;
  // four extremes' loads in flight per thread before the first is used
  constexpr int U = 4;
  float m = 0.f;
  const int step = Q * nthreads;
  for (int i0 = q * nthreads + tid; i0 < P * C; i0 += U * step) {
    float2 e[U];
    float g[U], b[U];
    int c[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * step;
      c[u] = i % C;
      if (i < P * C) {
        e[u] = ex[i];
        g[u] = gm[c[u]];
        b[u] = bt[c[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i0 + u * step >= P * C) break;
      const float2 st = s_stats[c[u] / cg];
      m = fmaxf(m, fmaxf(abs_y(e[u].x, st.x, st.y, g[u], b[u]),
                         abs_y(e[u].y, st.x, st.y, g[u], b[u])));
    }
  }
  m = block_max(m, scratch);
  if (tid == 0) cand[(size_t)n * Q + q] = m;
}

// The sample's largest |SiLU(t)| at the extremes, from the Q finalize
// blocks' values; every thread gets it.
__device__ __forceinline__ float candidate(const float* __restrict__ cand, int n, int Q,
                                           float* red) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  float m = 0.f;
  for (int k = tid; k < Q; k += nthreads) m = fmaxf(m, cand[(size_t)n * Q + k]);
  return block_max(m, red);
}

// blockDim = (C / V, TY); grid = (P, N).
template <typename T>
__global__ void __launch_bounds__(1024)
    gnq_amax_kernel(const T* __restrict__ x, const float2* __restrict__ stats,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    const float* __restrict__ cand, int Q, int full, int* __restrict__ flags,
                    float* __restrict__ amax_partial, int S, int C, int G,
                    int rows_per_chunk) {
  constexpr int V = Vec<T>::N;
  __shared__ float red[1024];
  const int n = blockIdx.y, p = blockIdx.x, P = gridDim.x;
  const bool flagged = full || !(candidate(cand, n, Q, red) >= kLobe);
  if (p == 0 && threadIdx.x == 0 && threadIdx.y == 0) flags[n] = flagged ? 1 : 0;
  if (!flagged) return;
  const int ty = threadIdx.y, TY = blockDim.y;
  const int c0 = threadIdx.x * V;
  Chain<V> ch;
  ch.init(stats + (size_t)n * G, gamma + (size_t)n * C, beta + (size_t)n * C, C, G, c0);
  const int r0 = p * rows_per_chunk;
  const int r1 = min(S, r0 + rows_per_chunk);
  const T* xn = x + (size_t)n * S * C + c0;
  float m = 0.f;
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
#pragma unroll
      for (int j = 0; j < V; ++j) m = fmaxf(m, fabsf(silu(ch.affine(v[j], j))));
    }
  }
  m = block_max(m, red);
  if (threadIdx.x == 0 && ty == 0) amax_partial[(size_t)n * P + p] = m;
}

// blockDim = (C / V, TY); grid = (P, N). A flagged sample's scale comes
// from its PA partial maxima in amax_partial; the flags are read from
// flags_in where it is given (a height shard's, set by its merge entry),
// else taken from the candidate as gnq_amax_kernel takes them.
template <typename T>
__global__ void __launch_bounds__(1024)
    gnq_quant_kernel(const T* __restrict__ x, const float2* __restrict__ stats,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     const float* __restrict__ cand, int Q, int full,
                     const int* __restrict__ flags_in, const float* __restrict__ amax_partial,
                     int PA, int8_t* __restrict__ xq, float* __restrict__ scale, int S, int C,
                     int G, int rows_per_chunk) {
  constexpr int V = Vec<T>::N;
  __shared__ float red[1024];
  const int n = blockIdx.y, p = blockIdx.x;
  const int ty = threadIdx.y, TY = blockDim.y;
  const int tid = ty * blockDim.x + threadIdx.x, nthreads = blockDim.x * TY;
  float m = candidate(cand, n, Q, red);
  if (flags_in != nullptr ? flags_in[n] != 0 : (full || !(m >= kLobe))) {
    // a flagged sample: the full pass's partial maxima
    m = 0.f;
    for (int k = tid; k < PA; k += nthreads) m = fmaxf(m, amax_partial[(size_t)n * PA + k]);
    m = block_max(m, red);
  }
  const float s = fmaxf(m, 1e-12f) / 127.f;
  if (p == 0 && tid == 0) scale[n] = s;
  const float rinv = 1.f / s;
  const int c0 = threadIdx.x * V;
  Chain<V> ch;
  ch.init(stats + (size_t)n * G, gamma + (size_t)n * C, beta + (size_t)n * C, C, G, c0);
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
      typename Codes<V>::type out;
      int8_t* q = reinterpret_cast<int8_t*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        q[j] = quant_code(silu(ch.affine(v[j], j)), s, rinv);
      }
      *reinterpret_cast<typename Codes<V>::type*>(xq + base + (size_t)(r + u * TY) * C) = out;
    }
  }
}

template <typename T>
int launch(const void* x, const float* gamma, const float* beta, float* scratch, int8_t* xq,
           float* scale, int N, int S, int C, int G, int rows, int P, int ty, int lanes,
           int Q, float eps, int full, int cluster, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  if (cluster)
    return launch_cluster<T, 2>(x, gamma, beta, xq, scale, reinterpret_cast<int*>(scratch), N,
                                S, C, G, rows, P, ty, eps, full, stream);
  float2* partial = reinterpret_cast<float2*>(scratch);
  float2* extrema = partial + (size_t)N * P * G;
  float2* stats = extrema + (size_t)N * P * C;
  float* amax_partial = reinterpret_cast<float*>(stats + (size_t)N * G);
  float* cand = amax_partial + (size_t)N * P;
  int* flags = reinterpret_cast<int*>(cand + (size_t)N * Q);
  const T* xt = static_cast<const T*>(x);
  const dim3 grid(P, N), block(C / V, ty);
  const size_t smem = partials_floats(true, ty, C) * sizeof(float);
  int err = allow_shared(gn_stats_kernel<T, true>, smem);
  if (err != 0) return err;
  gn_stats_kernel<T, true><<<grid, block, smem, stream>>>(xt, partial, extrema, S, C, G, rows);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  gnq_finalize_kernel<<<dim3(Q, N), dim3(lanes, G), 0, stream>>>(
      partial, extrema, gamma, beta, stats, cand, S, C, G, P, rows, eps);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  gnq_amax_kernel<T><<<grid, block, 0, stream>>>(xt, stats, gamma, beta, cand, Q, full, flags,
                                                 amax_partial, S, C, G, rows);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  gnq_quant_kernel<T><<<grid, block, 0, stream>>>(xt, stats, gamma, beta, cand, Q, full,
                                                  nullptr, amax_partial, P, xq, scale, S, C, G,
                                                  rows);
  return (int)cudaGetLastError();
}

// -- a height shard ----------------------------------------------------------
// Each rank holds some rows of every sample (maybe none). The partials of a
// shard, one row of 3G + 2C floats a sample: (mean, M2, count) of each
// group, then (min, max) of x in each channel (+inf, -inf for no rows,
// which the caller writes without a launch).

// blockDim = (L, G); grid = (N). The shard's group partials, merged over
// its chunks as gnq_finalize_kernel merges them, and its channels'
// extremes over its chunks.
__global__ void gnq_shard_stats_kernel(const float2* __restrict__ partial,
                                       const float2* __restrict__ extrema,
                                       float* __restrict__ part, int S, int C, int G, int P,
                                       int rows_per_chunk) {
  __shared__ float scratch[3 * 1024];
  __shared__ float2 s_stats[1024];
  const int n = blockIdx.x, cg = C / G;
  merge_groups<true>(partial, scratch, s_stats, n, S, G, P, rows_per_chunk, cg, 0.f);
  float* out = part + (size_t)n * (3 * G + 2 * C);
  if (threadIdx.x == 0) {
    const int g = threadIdx.y;
    out[3 * g] = s_stats[g].x;
    out[3 * g + 1] = s_stats[g].y;
    out[3 * g + 2] = (float)S * (float)cg;
  }
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const float2* ex = extrema + (size_t)n * P * C;
  for (int c = tid; c < C; c += nthreads) {
    float lo = INFINITY, hi = -INFINITY;
    for (int p = 0; p < P; ++p) {
      const float2 e = ex[(size_t)p * C + c];
      lo = fminf(lo, e.x);
      hi = fmaxf(hi, e.y);
    }
    out[3 * G + 2 * c] = lo;
    out[3 * G + 2 * c + 1] = hi;
  }
}

// blockDim = 256; grid = (N). The M ranks' partials of sample n, parts
// (M, N, 3G + 2C): the group statistics merged in rank order, each
// weighted by its count, into (mean, rstd); each channel's extremes over
// the ranks; from them, with the device functions the quantise pass
// applies, the sample's candidate abs-max (as gnq_finalize_kernel's, but
// from the whole sample's extremes of each channel).
__global__ void gnq_shard_merge_kernel(const float* __restrict__ parts, int M,
                                       const float* __restrict__ gamma,
                                       const float* __restrict__ beta,
                                       float2* __restrict__ stats, float* __restrict__ cand,
                                       int C, int G, float eps) {
  __shared__ float2 s_stats[1024];
  __shared__ float red[1024];
  const int n = blockIdx.x, N = gridDim.x, cg = C / G, row = 3 * G + 2 * C;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  for (int g = tid; g < G; g += nthreads) {
    float na = 0.f, ma = 0.f, qa = 0.f;
    for (int r = 0; r < M; ++r) {
      const float* v = parts + ((size_t)r * N + n) * row + 3 * g;
      chan_merge(na, ma, qa, v[2], v[0], v[1]);
    }
    s_stats[g] = make_float2(ma, 1.f / sqrtf(qa / na + eps));
    stats[(size_t)n * G + g] = s_stats[g];
  }
  __syncthreads();
  const float* gm = gamma + (size_t)n * C;
  const float* bt = beta + (size_t)n * C;
  float m = 0.f;
  for (int c = tid; c < C; c += nthreads) {
    float lo = INFINITY, hi = -INFINITY;
    for (int r = 0; r < M; ++r) {
      const float* e = parts + ((size_t)r * N + n) * row + 3 * G + 2 * c;
      lo = fminf(lo, e[0]);
      hi = fmaxf(hi, e[1]);
    }
    const float2 st = s_stats[c / cg];
    m = fmaxf(m, fmaxf(abs_y(lo, st.x, st.y, gm[c], bt[c]), abs_y(hi, st.x, st.y, gm[c], bt[c])));
  }
  m = block_max(m, red);
  if (tid == 0) cand[n] = m;
}

// blockDim = 256; grid = (N). A flagged sample's abs-max over this shard,
// from the P partial maxima of gnq_amax_kernel; 0 for an unflagged one.
__global__ void gnq_shard_amax_kernel(const int* __restrict__ flags,
                                      const float* __restrict__ amax_partial,
                                      float* __restrict__ amax, int P) {
  __shared__ float red[1024];
  const int n = blockIdx.x;
  float m = 0.f;
  if (flags[n])
    for (int k = threadIdx.x; k < P; k += blockDim.x)
      m = fmaxf(m, amax_partial[(size_t)n * P + k]);
  m = block_max(m, red);
  if (threadIdx.x == 0) amax[n] = m;
}

template <typename T>
int launch_shard_stats(const void* x, float* part, float* scratch, int N, int S, int C, int G,
                       int rows, int P, int ty, int lanes, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  float2* partial = reinterpret_cast<float2*>(scratch);
  float2* extrema = partial + (size_t)N * P * G;
  const size_t smem = partials_floats(true, ty, C) * sizeof(float);
  int err = allow_shared(gn_stats_kernel<T, true>, smem);
  if (err != 0) return err;
  gn_stats_kernel<T, true><<<dim3(P, N), dim3(C / V, ty), smem, stream>>>(
      static_cast<const T*>(x), partial, extrema, S, C, G, rows);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  gnq_shard_stats_kernel<<<N, dim3(lanes, G), 0, stream>>>(partial, extrema, part, S, C, G, P,
                                                           rows);
  return (int)cudaGetLastError();
}

// The work buffer of a shard's merge and apply entries: stats (N * G
// float2), candidates (N), partial maxima (N * P), the shard's abs-max (N),
// flags (N int32).
struct ShardWork {
  float2* stats;
  float* cand;
  float* amax_partial;
  float* amax;
  int* flags;
  ShardWork(float* w, int N, int G, int P)
      : stats(reinterpret_cast<float2*>(w)),
        cand(w + 2 * (size_t)N * G),
        amax_partial(cand + N),
        amax(amax_partial + (size_t)N * P),
        flags(reinterpret_cast<int*>(amax + N)) {}
};

template <typename T>
int launch_shard_merge(const void* x, const float* parts, int M, const float* gamma,
                       const float* beta, float* work, int N, int S, int C, int G, int rows,
                       int P, int ty, float eps, int full, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  ShardWork w(work, N, G, P);
  gnq_shard_merge_kernel<<<N, 256, 0, stream>>>(parts, M, gamma, beta, w.stats, w.cand, C, G,
                                                eps);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  gnq_amax_kernel<T><<<dim3(P, N), dim3(C / V, ty), 0, stream>>>(
      static_cast<const T*>(x), w.stats, gamma, beta, w.cand, 1, full, w.flags, w.amax_partial,
      S, C, G, rows);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  gnq_shard_amax_kernel<<<N, 256, 0, stream>>>(w.flags, w.amax_partial, w.amax, P);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_shard_apply(const void* x, const float* gamma, const float* beta, float* work,
                       const float* amax, int8_t* xq, float* scale, int N, int S, int C, int G,
                       int rows, int P, int ty, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  ShardWork w(work, N, G, P);
  gnq_quant_kernel<T><<<dim3(P, N), dim3(C / V, ty), 0, stream>>>(
      static_cast<const T*>(x), w.stats, gamma, beta, w.cand, 1, 0, w.flags, amax, 1, xq, scale,
      S, C, G, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. The caller (ops/gn_quant.py)
// validates shapes, types, contiguity and alignment, allocates the outputs
// (xq: N * S * C int8, scale: N f32) and one f32 scratch buffer, and chooses
// the path and the cut (ops/groupnorm.py::gn_plan). On the two-pass path the
// scratch holds the group partials (N * P * G float2), the extrema
// (N * P * C float2), the statistics (N * G float2), the partial maxima
// (N * P f32), the candidates (N * Q f32) and the flags (N int32); with
// `cluster`, the one-launch path of csrc/gn_cluster.cuh, only the flags.
// `full` flags every sample (the full abs-max pass, to compare with).
// Returns the first CUDA error code, 0 on success.
extern "C" int fh_gn_silu_quant_forward(const void* x, const float* gamma, const float* beta,
                                        float* scratch, int8_t* xq, float* scale, int N,
                                        int S, int C, int G, int rows_per_chunk, int P,
                                        int ty, int lanes, int Q, float eps, int is_bf16,
                                        int full, int cluster, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();  // so that an error reported here is this call's own
  if (is_bf16)
    return launch<__nv_bfloat16>(x, gamma, beta, scratch, xq, scale, N, S, C, G,
                                 rows_per_chunk, P, ty, lanes, Q, eps, full, cluster, s);
  return launch<float>(x, gamma, beta, scratch, xq, scale, N, S, C, G, rows_per_chunk, P, ty,
                       lanes, Q, eps, full, cluster, s);
}

// The entries of a height shard (ops/gn_quant.py::gn_silu_quant_sharded),
// bound with ctypes; the caller validates as for the entry above, gathers
// the shards' partials between the stats and the merge entry, and
// max-merges the flagged samples' abs-max (`work`'s amax) between the
// merge and the apply entry.
//   stats: part (N, 3G + 2C) f32 from the statistics pass over the shard's
//     S rows (scratch: N * P * (G + C) float2). Not called for S = 0.
//   merge: from parts (M, N, 3G + 2C), the merged statistics, candidates,
//     flags (`full` flags every sample) and the flagged samples' abs-max
//     over this shard into work (ShardWork; N * (2G + P + 3) floats). With
//     S = 0 the caller passes P = 1: the grids keep their shape, the passes
//     read no rows.
//   apply: the codes and the scale, a flagged sample's from amax (N).
// Each returns the first CUDA error code, 0 on success.
extern "C" int fh_gn_silu_quant_shard_stats(const void* x, float* part, float* scratch, int N,
                                            int S, int C, int G, int rows_per_chunk, int P,
                                            int ty, int lanes, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();
  if (is_bf16)
    return launch_shard_stats<__nv_bfloat16>(x, part, scratch, N, S, C, G, rows_per_chunk, P,
                                             ty, lanes, s);
  return launch_shard_stats<float>(x, part, scratch, N, S, C, G, rows_per_chunk, P, ty, lanes,
                                   s);
}

extern "C" int fh_gn_silu_quant_shard_merge(const void* x, const float* parts, int M,
                                            const float* gamma, const float* beta, float* work,
                                            int N, int S, int C, int G, int rows_per_chunk,
                                            int P, int ty, float eps, int full, int is_bf16,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();
  if (is_bf16)
    return launch_shard_merge<__nv_bfloat16>(x, parts, M, gamma, beta, work, N, S, C, G,
                                             rows_per_chunk, P, ty, eps, full, s);
  return launch_shard_merge<float>(x, parts, M, gamma, beta, work, N, S, C, G, rows_per_chunk, P,
                                   ty, eps, full, s);
}

extern "C" int fh_gn_silu_quant_shard_apply(const void* x, const float* gamma, const float* beta,
                                            float* work, const float* amax, int8_t* xq,
                                            float* scale, int N, int S, int C, int G,
                                            int rows_per_chunk, int P, int ty, int is_bf16,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();
  if (is_bf16)
    return launch_shard_apply<__nv_bfloat16>(x, gamma, beta, work, amax, xq, scale, N, S, C, G,
                                             rows_per_chunk, P, ty, s);
  return launch_shard_apply<float>(x, gamma, beta, work, amax, xq, scale, N, S, C, G,
                                   rows_per_chunk, P, ty, s);
}
