// The input gradient of GroupNorm(G)(+SiLU) over a channels-last (N, S, C)
// tensor: the pullback of K1 (csrc/groupnorm.cu), for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package differentiates its plain jnp
// reference (free_hunch_tpu/ops/pallas_groupnorm.py, custom_vjp _bwd
// :156-160), and the port did the same under autograd, about 40 float32
// ATen launches a norm. With x^ = (x - mean) * rstd, z = gamma x^ + beta and
// dy^ = dy * SiLU'(z) * gamma (without SiLU: dy * gamma), per (sample,
// group) of M = S * C / G elements:
//   dx = rstd * (dy^ - mean(dy^) - x^ * mean(dy^ * x^))
// The sums are taken in f32 in a fixed order (no atomics: dx is bitwise the
// same from run to run); dx is rounded once, to x's type. dgamma and dbeta
// are not computed (ops/groupnorm.py keeps plain autograd where they are
// asked for).
//
// Bound: device-memory bytes. The function reads x and dy once and writes
// dx once (flops.gn_backward_bytes); about 25 instructions an element. The
// two sums must be complete before any dx is written, and a sample of up to
// 67 MB (x and dy) cannot stay on chip, so a large call reads x and dy
// twice: 5 units of the function's 3, at most 60 % of the bound.
//   Two-pass path (64-256 px), two launches:
//   1. gn_bwd_reduce_kernel, grid (P chunks, N samples): reads x and dy,
//      writes (sum dy^, sum dy^ x^) per (sample, chunk, group).
//   2. gn_bwd_apply_kernel, same grid: each block merges its sample's P
//      chunk partials in chunk order (lanes, then the lanes in order), then
//      reads x and dy again and writes dx.
//   The statistics (mean, rstd) per (sample, group) come from the forward's
//   two-pass path, which computed them (the tail of its scratch).
//   Cluster path (8-32 px, and every call whose forward took K1's one-launch
//   path, which keeps no statistics), one launch: one thread-block cluster
//   of P <= 8 blocks a sample (as csrc/gn_cluster.cuh): the statistics
//   (unless carried), then the two sums, each merged across the cluster in
//   chunk order through distributed shared memory, then dx; the re-reads of
//   a sample of at most a few MB come from L2. These calls are too small to
//   fill the card, and a launch sequence would cost more than their bytes.
// Each thread owns V channels (one 16-byte vector) and walks its chunk's
// rows TY apart, kBwdUnroll rows of x and dy in flight (64 bytes, as the
// forward's streaming passes). SiLU' takes __expf and an approximate
// reciprocal, within a few f32 ulps.
#pragma once

#include <cooperative_groups.h>

#include "gn_stats.cuh"

namespace {

constexpr int kBwdUnroll = 2;     // rows of x and dy whose loads a thread issues together
constexpr int kBwdThreads = 512;  // the most threads a backward block has

// The per-element chain of the backward for one thread's V channels: x^
// and dy^ of one element from its x, its dy and the channel's constants.
template <int V, bool SILU>
struct BwdChain {
  Chain<V> ch;
  __device__ __forceinline__ void eval(float v, float d, int j, float& xh, float& dyh) const {
    xh = __fmul_rn(__fsub_rn(v, ch.mu[j]), ch.rs[j]);
    if (SILU) {
      const float z = __fmaf_rn(xh, ch.gm[j], ch.bt[j]);
      const float s = __fdividef(1.f, 1.f + __expf(-z));
      d = d * (s * (1.f + z * (1.f - s)));
    }
    dyh = d * ch.gm[j];
  }
};

// Walk rows [r0, r1) of one sample (base: its first element of this
// thread's channels) and add dy^ and dy^ x^ of each channel into a and b.
template <typename T, bool SILU>
__device__ __forceinline__ void bwd_sum_rows(const T* __restrict__ x, const T* __restrict__ dy,
                                             const BwdChain<Vec<T>::N, SILU>& bc, float* a,
                                             float* b, size_t base, int r0, int r1, int C) {
  constexpr int V = Vec<T>::N;
  const int TY = blockDim.y;
  for (int r = r0 + threadIdx.y; r < r1; r += kBwdUnroll * TY) {
    uint4 rx[kBwdUnroll], rd[kBwdUnroll];
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u)
      if (r + u * TY < r1) {
        const size_t off = base + (size_t)(r + u * TY) * C;
        rx[u] = load16(x + off);
        rd[u] = load16(dy + off);
      }
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      if (r + u * TY >= r1) break;
      float v[V], d[V];
      Vec<T>::cvt(rx[u], v);
      Vec<T>::cvt(rd[u], d);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float xh, dyh;
        bc.eval(v[j], d[j], j, xh, dyh);
        a[j] += dyh;
        b[j] = __fmaf_rn(dyh, xh, b[j]);
      }
    }
  }
}

// Walk rows [r0, r1) again and write dx = rstd (dy^ - ca - x^ cb), where
// (ca, cb) are the group means of dy^ and dy^ x^ for each channel.
template <typename T, bool SILU>
__device__ __forceinline__ void bwd_apply_rows(const T* __restrict__ x, const T* __restrict__ dy,
                                               T* __restrict__ dx,
                                               const BwdChain<Vec<T>::N, SILU>& bc,
                                               const float* ca, const float* cb, size_t base,
                                               int r0, int r1, int C) {
  constexpr int V = Vec<T>::N;
  const int TY = blockDim.y;
  for (int r = r0 + threadIdx.y; r < r1; r += kBwdUnroll * TY) {
    uint4 rx[kBwdUnroll], rd[kBwdUnroll];
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u)
      if (r + u * TY < r1) {
        const size_t off = base + (size_t)(r + u * TY) * C;
        rx[u] = load16(x + off);
        rd[u] = load16(dy + off);
      }
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      if (r + u * TY >= r1) break;
      float v[V], d[V];
      Vec<T>::cvt(rx[u], v);
      Vec<T>::cvt(rd[u], d);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float xh, dyh;
        bc.eval(v[j], d[j], j, xh, dyh);
        v[j] = __fmul_rn(bc.ch.rs[j], __fsub_rn(__fsub_rn(dyh, ca[j]), __fmul_rn(xh, cb[j])));
      }
      Vec<T>::store(dx + base + (size_t)(r + u * TY) * C, v);
    }
  }
}

// A block of (C / V, TY) threads that has summed its rows: add the TY row
// sums of each channel in ty order, then the group's channels in order,
// into groups_out[g] = (sum dy^, sum dy^ x^) of the block's rows of group
// g. smem: 2 * TY * C floats.
template <int V>
__device__ __forceinline__ void bwd_block_sums(const float* a, const float* b, float* smem,
                                               int C, int G, float2* groups_out) {
  const int tx = threadIdx.x, ty = threadIdx.y, TX = blockDim.x, TY = blockDim.y;
  const int c0 = tx * V;
  float* s_a = smem;
  float* s_b = smem + TY * C;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s_a[ty * C + c0 + j] = a[j];
    s_b[ty * C + c0 + j] = b[j];
  }
  __syncthreads();
  const int tid = ty * TX + tx, nthreads = TX * TY;
  for (int c = tid; c < C; c += nthreads) {
    float sa = s_a[c], sb = s_b[c];
    for (int k = 1; k < TY; ++k) {
      sa += s_a[k * C + c];
      sb += s_b[k * C + c];
    }
    s_a[c] = sa;
    s_b[c] = sb;
  }
  __syncthreads();
  const int cg = C / G;
  for (int g = tid; g < G; g += nthreads) {
    float sa = 0.f, sb = 0.f;
    for (int j = 0; j < cg; ++j) {
      sa += s_a[g * cg + j];
      sb += s_b[g * cg + j];
    }
    groups_out[g] = make_float2(sa, sb);
  }
}

// The constants of one thread's V channels: the chain from the sample's
// (mean, rstd), and the group means (ca, cb) from coef (G float2).
template <int V, bool SILU>
__device__ __forceinline__ void bwd_init(BwdChain<V, SILU>& bc, float* ca, float* cb,
                                         const float2* stats_n, const float2* coef,
                                         const float* gamma, const float* beta, int C, int G,
                                         int c0) {
  bc.ch.init(stats_n, gamma, beta, C, G, c0);
  if (coef == nullptr) return;
  const int cg = C / G;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float2 k = coef[(c0 + j) / cg];
    ca[j] = k.x;
    cb[j] = k.y;
  }
}

// blockDim = (C / V, TY); grid = (P, N). Dynamic shared memory 2 * TY * C
// floats. stats: (N, G) (mean, rstd); partial: (N, P, G) sums out.
template <typename T, bool SILU>
__global__ void __launch_bounds__(kBwdThreads)
    gn_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         const float2* __restrict__ stats, const float* __restrict__ gamma,
                         const float* __restrict__ beta, float2* __restrict__ partial, int S,
                         int C, int G, int rows_per_chunk) {
  constexpr int V = Vec<T>::N;
  extern __shared__ float smem[];
  const int n = blockIdx.y, p = blockIdx.x, P = gridDim.x;
  const int c0 = threadIdx.x * V;
  BwdChain<V, SILU> bc;
  bwd_init<V, SILU>(bc, nullptr, nullptr, stats + (size_t)n * G, nullptr, gamma, beta, C, G,
                    c0);
  float a[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) a[j] = b[j] = 0.f;
  const int r0 = p * rows_per_chunk;
  bwd_sum_rows<T, SILU>(x, dy, bc, a, b, (size_t)n * S * C + c0, r0,
                        min(S, r0 + rows_per_chunk), C);
  bwd_block_sums<V>(a, b, smem, C, G, partial + ((size_t)n * P + p) * G);
}

// blockDim = (C / V, TY), at least G threads; grid = (P, N). Each block
// merges its sample's P partials of each group (L = threads / G lanes, lane
// l taking chunks l, l + L, ..., then the lanes in order) into the group
// means, then writes dx for its chunk's rows.
template <typename T, bool SILU>
__global__ void __launch_bounds__(kBwdThreads)
    gn_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                        const float2* __restrict__ stats, const float* __restrict__ gamma,
                        const float* __restrict__ beta, const float2* __restrict__ partial,
                        T* __restrict__ dx, int S, int C, int G, int rows_per_chunk) {
  constexpr int V = Vec<T>::N;
  __shared__ float2 s_lane[kBwdThreads];
  __shared__ float2 s_coef[kBwdThreads];
  const int n = blockIdx.y, p = blockIdx.x, P = gridDim.x;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int L = blockDim.x * blockDim.y / G;
  if (tid < L * G) {
    const int g = tid / L, l = tid % L;
    float sa = 0.f, sb = 0.f;
    for (int q = l; q < P; q += L) {
      const float2 v = partial[((size_t)n * P + q) * G + g];
      sa += v.x;
      sb += v.y;
    }
    s_lane[tid] = make_float2(sa, sb);
  }
  __syncthreads();
  if (tid < G) {
    float sa = 0.f, sb = 0.f;
    for (int l = 0; l < L; ++l) {
      const float2 v = s_lane[tid * L + l];
      sa += v.x;
      sb += v.y;
    }
    const float inv_m = 1.f / ((float)S * (float)(C / G));
    s_coef[tid] = make_float2(sa * inv_m, sb * inv_m);
  }
  __syncthreads();
  const int c0 = threadIdx.x * V;
  BwdChain<V, SILU> bc;
  float ca[V], cb[V];
  bwd_init<V, SILU>(bc, ca, cb, stats + (size_t)n * G, s_coef, gamma, beta, C, G, c0);
  const int r0 = p * rows_per_chunk;
  bwd_apply_rows<T, SILU>(x, dy, dx, bc, ca, cb, (size_t)n * S * C + c0, r0,
                          min(S, r0 + rows_per_chunk), C);
}

namespace cgb = cooperative_groups;

// The cluster path: blockDim = (C / V, TY); grid = (P, N), clusters of
// (P, 1, 1), one a sample; G <= kBwdThreads. Dynamic shared memory
// partials_floats(false, TY, C) floats. With CARRIED the (mean, rstd) come
// from stats (N, G); else they are computed here as gn_cluster_kernel
// computes them (Welford over each chunk, Chan merges in chunk order).
template <typename T, bool SILU, bool CARRIED>
__global__ void __launch_bounds__(kBwdThreads)
    gn_bwd_cluster_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                          const float2* __restrict__ stats, const float* __restrict__ gamma,
                          const float* __restrict__ beta, T* __restrict__ dx, int S, int C,
                          int G, int rows_per_chunk, float eps) {
  constexpr int V = Vec<T>::N;
  extern __shared__ float smem[];
  __shared__ float2 s_part[kBwdThreads];
  __shared__ float2 s_stats[kBwdThreads];
  __shared__ float2 s_coef[kBwdThreads];
  cgb::cluster_group cluster = cgb::this_cluster();
  const int p = blockIdx.x, P = gridDim.x, n = blockIdx.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x, nthreads = blockDim.x * blockDim.y;
  const int r0 = p * rows_per_chunk;
  const int r1 = min(S, r0 + rows_per_chunk);
  const int c0 = threadIdx.x * V;
  const int cg = C / G;
  const size_t base = (size_t)n * S * C + c0;

  // 1. the statistics of the sample's groups into s_stats
  if (CARRIED) {
    for (int g = tid; g < G; g += nthreads) s_stats[g] = stats[(size_t)n * G + g];
    __syncthreads();
  } else {
    float mean[V], m2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) mean[j] = m2[j] = 0.f;
    int cnt = 0;
    const int TY = blockDim.y;
    for (int r = r0 + threadIdx.y; r < r1; r += kUnroll * TY) {
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (r + u * TY < r1) raw[u] = load16(x + base + (size_t)(r + u * TY) * C);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * TY >= r1) break;
        float v[V];
        Vec<T>::cvt(raw[u], v);
        welford_row<V, false>(v, mean, m2, nullptr, nullptr, cnt);
      }
    }
    block_partials<V, false>(mean, m2, nullptr, nullptr, cnt, smem, C, G, r1 - r0, s_part,
                             nullptr);
    cluster.sync();
    for (int g = tid; g < G; g += nthreads) {
      float na = 0.f, ma = 0.f, qa = 0.f;
      for (int q = 0; q < P; ++q) {
        const float2 v = *cluster.map_shared_rank(&s_part[g], q);
        const int rows = min(rows_per_chunk, S - q * rows_per_chunk);
        chan_merge(na, ma, qa, (float)rows * (float)cg, v.x, v.y);
      }
      s_stats[g] = make_float2(ma, 1.f / sqrtf(qa / na + eps));
    }
    // no block reuses s_part, or its shared memory, while another may still read it
    cluster.sync();
  }

  // 2. the chunk's sums, then the sample's group means across the cluster
  BwdChain<V, SILU> bc;
  float a[V], b[V];
  bwd_init<V, SILU>(bc, nullptr, nullptr, s_stats, nullptr, gamma, beta, C, G, c0);
#pragma unroll
  for (int j = 0; j < V; ++j) a[j] = b[j] = 0.f;
  bwd_sum_rows<T, SILU>(x, dy, bc, a, b, base, r0, r1, C);
  bwd_block_sums<V>(a, b, smem, C, G, s_part);
  cluster.sync();
  const float inv_m = 1.f / ((float)S * (float)cg);
  for (int g = tid; g < G; g += nthreads) {
    float sa = 0.f, sb = 0.f;
    for (int q = 0; q < P; ++q) {
      const float2 v = *cluster.map_shared_rank(&s_part[g], q);
      sa += v.x;
      sb += v.y;
    }
    s_coef[g] = make_float2(sa * inv_m, sb * inv_m);
  }
  // no block leaves while another may still read its s_part
  cluster.sync();

  // 3. dx
  float ca[V], cb[V];
  bwd_init<V, SILU>(bc, ca, cb, s_stats, s_coef, gamma, beta, C, G, c0);
  bwd_apply_rows<T, SILU>(x, dy, dx, bc, ca, cb, base, r0, r1, C);
}

// Launch gn_bwd_cluster_kernel<T, SILU, CARRIED> on N clusters of P blocks.
template <typename T, bool SILU, bool CARRIED>
int launch_bwd_cluster(const void* x, const void* dy, const float2* stats, const float* gamma,
                       const float* beta, void* dx, int N, int S, int C, int G, int rows, int P,
                       int ty, float eps, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  auto kernel = gn_bwd_cluster_kernel<T, SILU, CARRIED>;
  const size_t smem = partials_floats(false, ty, C) * sizeof(float);
  // the kernel's 12 KB of static shared memory counts against the 48 KB a
  // launch gets without this attribute
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P, N);
  cfg.blockDim = dim3(C / V, ty);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                                static_cast<const T*>(dy), stats, gamma, beta,
                                static_cast<T*>(dx), S, C, G, rows, eps);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

// The two launches of the two-pass path, with (mean, rstd) in stats.
template <typename T, bool SILU>
int launch_bwd_two_pass(const void* x, const void* dy, const float2* stats, const float* gamma,
                        const float* beta, void* dx, float2* partial, int N, int S, int C, int G,
                        int rows, int P, int ty, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const dim3 grid(P, N), block(C / V, ty);
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const size_t smem = 2 * (size_t)ty * C * sizeof(float);
  int err = allow_shared(gn_bwd_reduce_kernel<T, SILU>, smem);
  if (err != 0) return err;
  gn_bwd_reduce_kernel<T, SILU><<<grid, block, smem, stream>>>(xt, dyt, stats, gamma, beta,
                                                               partial, S, C, G, rows);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  gn_bwd_apply_kernel<T, SILU><<<grid, block, 0, stream>>>(xt, dyt, stats, gamma, beta, partial,
                                                           static_cast<T*>(dx), S, C, G, rows);
  return (int)cudaGetLastError();
}

}  // namespace
