// The one-launch path of K1 (csrc/groupnorm.cu) and K2 (csrc/gn_quant.cu)
// for calls whose sample fits the shared memory of a thread-block cluster,
// for Hopper (sm_90a).
//
// A small call (8-32 px at batch 8: a few hundred KB to 1 MB a sample) is
// too small to fill the card, and on the two-pass path it pays three or four
// dependent launches for a few microseconds of work each. Here one cluster
// of P <= 8 blocks (one block per SM) holds one sample: block p copies its
// chunk of rows into its shared memory as it reads them, so x is read ONCE;
// the group statistics, and K2's abs-max, are reduced across the cluster
// through distributed shared memory behind cluster barriers; the output is
// written once. ops/groupnorm.py::gn_plan takes this path where the chunk of
// a sample (rows_per_chunk * C * itemsize bytes) and the statistics' shared
// memory fit a block.
//
// The arithmetic is the two-pass path's, in the same order: each block
// walks its chunk exactly as gn_stats_kernel does (welford_row,
// block_partials), the chunk partials are merged in chunk order as
// merge_groups merges them when P <= its lanes, and every element goes
// through the same Chain and silu. So with the two-pass path cut into the
// same chunks, the results are bitwise equal; K2's abs-max here is the
// exact max over the sample's elements, which is what the two-pass path
// takes from the extremes (or from its full pass on a flagged sample).
#pragma once

#include <cooperative_groups.h>

#include "gn_stats.cuh"

namespace {

namespace cgx = cooperative_groups;

// MODE: 0 K1 without SiLU, 1 K1 with SiLU, 2 K2 (SiLU, quantise).
// blockDim = (C / V, TY); grid = (P, N), clusters of (P, 1, 1). Dynamic
// shared memory: rows_per_chunk * C values of x, then
// partials_floats(false, TY, C) floats. gamma and beta: (C,) for K1,
// (N, C) for K2; out: y (N, S, C) of T for K1, codes (N, S, C) int8 for K2.
template <typename T, int MODE>
__global__ void __launch_bounds__(1024)
    gn_cluster_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, void* __restrict__ out,
                      float* __restrict__ scale, int* __restrict__ flags, int S, int C, int G,
                      int rows_per_chunk, float eps, int full) {
  constexpr int V = Vec<T>::N;
  extern __shared__ uint4 smem_vec[];
  __shared__ float2 s_part[1024];
  __shared__ float2 s_stats[1024];
  __shared__ float red[1024];
  __shared__ float s_amax;
  cgx::cluster_group cluster = cgx::this_cluster();
  const int p = blockIdx.x, P = gridDim.x, n = blockIdx.y;
  const int tx = threadIdx.x, ty = threadIdx.y, TX = blockDim.x, TY = blockDim.y;
  const int tid = ty * TX + tx;
  const int r0 = p * rows_per_chunk;
  const int r1 = min(S, r0 + rows_per_chunk);
  const int c0 = tx * V;
  uint4* xs = smem_vec;                       // the chunk's rows, TX vectors a row
  float* part_smem = reinterpret_cast<float*>(smem_vec + (size_t)rows_per_chunk * TX);

  // 1. read the chunk once: keep it, and its Welford state, as
  //    gn_stats_kernel does
  const T* xn = x + (size_t)n * S * C + c0;
  float mean[V], m2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mean[j] = 0.f;
    m2[j] = 0.f;
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
      xs[(size_t)(r + u * TY - r0) * TX + tx] = raw[u];
      float v[V];
      Vec<T>::cvt(raw[u], v);
      welford_row<V, false>(v, mean, m2, nullptr, nullptr, cnt);
    }
  }
  block_partials<V, false>(mean, m2, nullptr, nullptr, cnt, part_smem, C, G, r1 - r0, s_part,
                           nullptr);

  // 2. every block merges the P chunk partials of each group, in chunk order,
  //    from the cluster's shared memory
  cluster.sync();
  const int cg = C / G;
  for (int g = tid; g < G; g += TX * TY) {
    float na = 0.f, ma = 0.f, qa = 0.f;
    for (int q = 0; q < P; ++q) {
      const float2 v = *cluster.map_shared_rank(&s_part[g], q);
      const int rows = min(rows_per_chunk, S - q * rows_per_chunk);
      chan_merge(na, ma, qa, (float)rows * (float)cg, v.x, v.y);
    }
    const float var = qa / na;
    s_stats[g] = make_float2(ma, 1.f / sqrtf(var + eps));
  }
  // no block leaves, or reuses s_part, while another may still read it
  cluster.sync();

  const size_t gstride = MODE == 2 ? (size_t)n * C : 0;
  Chain<V> ch;
  ch.init(s_stats, gamma + gstride, beta + gstride, C, G, c0);
  const size_t base = (size_t)n * S * C + c0;
  if (MODE < 2) {
    // 3. K1: normalise the kept rows and write y
    T* y = static_cast<T*>(out);
    for (int r = r0 + ty; r < r1; r += TY) {
      float v[V];
      Vec<T>::cvt(xs[(size_t)(r - r0) * TX + tx], v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float t = ch.affine(v[j], j);
        v[j] = MODE == 1 ? silu(t) : t;
      }
      Vec<T>::store(y + base + (size_t)r * C, v);
    }
    return;
  }
  // 3. K2: the chunk's max |y|, the sample's across the cluster, then the codes
  float m = 0.f;
  for (int r = r0 + ty; r < r1; r += TY) {
    float v[V];
    Vec<T>::cvt(xs[(size_t)(r - r0) * TX + tx], v);
#pragma unroll
    for (int j = 0; j < V; ++j) m = fmaxf(m, fabsf(silu(ch.affine(v[j], j))));
  }
  m = block_max(m, red);
  if (tid == 0) s_amax = m;
  cluster.sync();
  m = 0.f;
  for (int q = 0; q < P; ++q) m = fmaxf(m, *cluster.map_shared_rank(&s_amax, q));
  cluster.sync();
  const float s = fmaxf(m, 1e-12f) / 127.f;
  const float rinv = 1.f / s;
  if (p == 0 && tid == 0) {
    scale[n] = s;
    flags[n] = (full || !(m >= kLobe)) ? 1 : 0;
  }
  int8_t* xq = static_cast<int8_t*>(out);
  for (int r = r0 + ty; r < r1; r += TY) {
    float v[V];
    Vec<T>::cvt(xs[(size_t)(r - r0) * TX + tx], v);
    typename Codes<V>::type out;
    int8_t* q = reinterpret_cast<int8_t*>(&out);
#pragma unroll
    for (int j = 0; j < V; ++j) q[j] = quant_code(silu(ch.affine(v[j], j)), s, rinv);
    *reinterpret_cast<typename Codes<V>::type*>(xq + base + (size_t)r * C) = out;
  }
}

// Dynamic shared memory of gn_cluster_kernel, in bytes.
__host__ __device__ constexpr size_t cluster_smem(int rows_per_chunk, int C, int itemsize,
                                                  int ty) {
  return (size_t)rows_per_chunk * C * itemsize + partials_floats(false, ty, C) * 4;
}

// Launch gn_cluster_kernel<T, MODE> on N clusters of P blocks.
template <typename T, int MODE>
int launch_cluster(const void* x, const float* gamma, const float* beta, void* out,
                   float* scale, int* flags, int N, int S, int C, int G, int rows, int P,
                   int ty, float eps, int full, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  auto kernel = gn_cluster_kernel<T, MODE>;
  const size_t smem = cluster_smem(rows, C, (int)sizeof(T), ty);
  // the kernel's 16-20.5 KB of static shared memory counts against the
  // 48 KB a launch gets without this attribute
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
  err = (int)cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), gamma, beta, out,
                                scale, flags, S, C, G, rows, eps, full);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

}  // namespace
