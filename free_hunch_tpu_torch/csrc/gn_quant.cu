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
// (gamma, beta) by the caller. The quantiser DIVIDES by s_n, as the twin
// does (:67); the Pallas kernel multiplies by 1/s_n (:136), which can flip a
// code at an exact tie. Rounding is half to even (rintf), as jnp.round and
// torch.round do.
//
// Bound: device-memory bytes, ~15 flops per element. The least traffic is
// one read of x and one int8 write: 805 MB, 0.240 ms at 3.35 TB/s, for the
// largest call (8, 256*256, 512) bf16. The per-sample abs-max must be
// complete before the first code is written, and Hopper's blocks cannot
// carry a running value from one to the next as the TPU's sequential grid
// does, so each pass is a grid of its own and x is read three times:
//   1-2. K2a, gn_stats_kernel + gn_finalize_kernel (csrc/gn_stats.cuh,
//        shared with K1): (mean, rstd) per (sample, group), centred variance
//        instead of the TPU kernel's E[x^2] - E[x]^2 (:72-81, :104).
//   3.   K2b, gnq_amax_kernel, grid (P2 chunks, N): normalises its rows and
//        writes one max|y| per (sample, chunk). No atomics: max does not
//        depend on order, so the result is deterministic.
//   4.   K2c, gnq_quant_kernel, same grid: every block reduces its sample's
//        P2 partial maxima (a few hundred bytes), normalises again and
//        writes 16 int8 codes per thread with one 16-byte store; the first
//        block of each sample writes s_n.

#include "gn_stats.cuh"

namespace {

constexpr int QV = 16;  // channels per thread in the amax and quantise passes

template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out) {
  constexpr int V = Vec<T>::N;
#pragma unroll
  for (int i = 0; i < QV / V; ++i) Vec<T>::load(p + i * V, out + i * V);
}

// The per-thread constants of the normalise+affine+SiLU chain for channels
// c0 .. c0+15 of sample n.
struct Chain {
  float mu[QV], rs[QV], gm[QV], bt[QV];
  __device__ __forceinline__ void init(const float2* stats, const float* gamma,
                                       const float* beta, int n, int C, int G, int c0) {
    const int cg = C / G;
#pragma unroll
    for (int j = 0; j < QV; ++j) {
      const int c = c0 + j;
      const float2 st = stats[(size_t)n * G + c / cg];
      mu[j] = st.x;
      rs[j] = st.y;
      gm[j] = gamma[(size_t)n * C + c];
      bt[j] = beta[(size_t)n * C + c];
    }
  }
  __device__ __forceinline__ float apply(float v, int j) const {
    float t = (v - mu[j]) * rs[j];
    t = t * gm[j] + bt[j];
    return t * (1.f / (1.f + expf(-t)));
  }
};

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
  return red[0];
}

// blockDim = (C / 16, TY); grid = (P2, N).
template <typename T>
__global__ void gnq_amax_kernel(const T* __restrict__ x, const float2* __restrict__ stats,
                                const float* __restrict__ gamma, const float* __restrict__ beta,
                                float* __restrict__ amax_partial, int S, int C, int G,
                                int rows_per_chunk) {
  __shared__ float smem[1024];
  const int n = blockIdx.y, p = blockIdx.x, P = gridDim.x;
  const int tx = threadIdx.x, ty = threadIdx.y, TY = blockDim.y;
  const int c0 = tx * QV;
  Chain ch;
  ch.init(stats, gamma, beta, n, C, G, c0);
  const int r0 = p * rows_per_chunk;
  const int r1 = min(S, r0 + rows_per_chunk);
  const T* xn = x + (size_t)n * S * C;
  float m = 0.f;
  for (int r = r0 + ty; r < r1; r += TY) {
    float v[QV];
    load16(xn + (size_t)r * C + c0, v);
#pragma unroll
    for (int j = 0; j < QV; ++j) m = fmaxf(m, fabsf(ch.apply(v[j], j)));
  }
  m = block_max(m, smem);
  if (tx == 0 && ty == 0) amax_partial[(size_t)n * P + p] = m;
}

// blockDim = (C / 16, TY); grid = (P2, N).
template <typename T>
__global__ void gnq_quant_kernel(const T* __restrict__ x, const float2* __restrict__ stats,
                                 const float* __restrict__ gamma, const float* __restrict__ beta,
                                 const float* __restrict__ amax_partial, int8_t* __restrict__ xq,
                                 float* __restrict__ scale, int S, int C, int G,
                                 int rows_per_chunk) {
  __shared__ float smem[1024];
  const int n = blockIdx.y, p = blockIdx.x, P = gridDim.x;
  const int tx = threadIdx.x, ty = threadIdx.y, TY = blockDim.y;
  const int tid = ty * blockDim.x + tx, nthreads = blockDim.x * TY;
  float m = 0.f;
  for (int k = tid; k < P; k += nthreads) m = fmaxf(m, amax_partial[(size_t)n * P + k]);
  m = block_max(m, smem);
  const float s = fmaxf(m, 1e-12f) / 127.f;
  if (p == 0 && tid == 0) scale[n] = s;

  const int c0 = tx * QV;
  Chain ch;
  ch.init(stats, gamma, beta, n, C, G, c0);
  const int r0 = p * rows_per_chunk;
  const int r1 = min(S, r0 + rows_per_chunk);
  const size_t base = (size_t)n * S * C;
  for (int r = r0 + ty; r < r1; r += TY) {
    float v[QV];
    load16(x + base + (size_t)r * C + c0, v);
    uint4 out;
    int8_t* q = reinterpret_cast<int8_t*>(&out);
#pragma unroll
    for (int j = 0; j < QV; ++j) {
      const float c = fminf(fmaxf(rintf(ch.apply(v[j], j) / s), -127.f), 127.f);
      q[j] = (int8_t)(int)c;
    }
    *reinterpret_cast<uint4*>(xq + base + (size_t)r * C + c0) = out;
  }
}

template <typename T>
int launch(const void* x, const float* gamma, const float* beta, void* stat_partial,
           void* stats, float* amax_partial, int8_t* xq, float* scale, int N, int S, int C,
           int G, int rows1, int P1, int ty1, int lanes, int rows2, int P2, int ty2,
           float eps, cudaStream_t stream) {
  int err = launch_gn_stats<T>(x, stat_partial, stats, N, S, C, G, rows1, P1, ty1, lanes,
                               eps, stream);
  if (err != 0) return err;
  const dim3 grid(P2, N), block(C / QV, ty2);
  gnq_amax_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float2*>(stats), gamma, beta, amax_partial,
      S, C, G, rows2);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  gnq_quant_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float2*>(stats), gamma, beta, amax_partial,
      xq, scale, S, C, G, rows2);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. The caller (ops/gn_quant.py)
// validates shapes, types, contiguity and alignment, allocates the outputs
// (xq: N * S * C int8, scale: N f32) and the scratch buffers (stat_partial:
// N * P1 * G float2, stats: N * G float2, amax_partial: N * P2 f32) and
// chooses both chunkings. Returns the first CUDA error code, 0 on success.
extern "C" int fh_gn_silu_quant_forward(const void* x, const float* gamma, const float* beta,
                                        void* stat_partial, void* stats, float* amax_partial,
                                        int8_t* xq, float* scale, int N, int S, int C, int G,
                                        int rows1, int P1, int ty1, int lanes, int rows2,
                                        int P2, int ty2, float eps, int is_bf16,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, gamma, beta, stat_partial, stats, amax_partial, xq, scale,
                                 N, S, C, G, rows1, P1, ty1, lanes, rows2, P2, ty2, eps, s);
  return launch<float>(x, gamma, beta, stat_partial, stats, amax_partial, xq, scale, N, S, C,
                       G, rows1, P1, ty1, lanes, rows2, P2, ty2, eps, s);
}
