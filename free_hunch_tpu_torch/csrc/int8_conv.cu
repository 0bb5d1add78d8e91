// Stride-1 int8 convolution, NHWC x (O, kh, kw, I) -> s32, with a
// dequantising epilogue, for Hopper (sm_90a).
//
// Replaces the int8 convolutions of free_hunch_tpu/ops/quant.py, which are
// XLA ops rather than Pallas (jax.lax.conv_general_dilated on s8 x s8 -> s32
// at :96-99, :116-119, :204-207, :381-384, :397-400; the dense products at
// :139-141, :153-155, :229-231 are the same function as a 1x1 convolution
// over (n, t, 1, c)). One kernel serves every forward, the int8 pullback
// (flipped, I/O-swapped weights with padding k-1-pad) and the dense sites:
//   acc[n, oh, ow, o] = sum_{r, s, i} x[n, oh+r-pad, ow+s-pad, i] * w[o, r, s, i]
//   out = acc                                  (out_mode 0, int32)
//   out = f32(acc) * (ascale[n] * wscale[o])   (out_mode 1 f32, 2 bf16 RNE)
// The epilogue multiplies in that association, without contraction, so it
// equals the plain PyTorch epilogue bit for bit. The int32 sum cannot
// overflow: 127^2 * 9 * 2048 < 2^31.
//
// Bound: tensor-core operations at the large shapes. The largest call, the
// 256 px decoder 3x3 conv 512 -> 256 at batch 8, is 1.24e12 int8 operations,
// 0.625 ms at the H100's 1,979 dense int8 TOP/s; its operands are 0.27 GB.
//
// Design (simple and right first; wgmma and TMA come later): an implicit
// GEMM with M = n*Ho*Wo output pixels, N = O output channels and K =
// kh*kw*I, never materialising the im2col (2.4 GB for the largest call).
// The weights are laid out K-contiguous per output channel once per weight
// (by the caller). A block computes a 128 x 128 output tile with 8 warps of
// 64 x 32; K advances 64 bytes at a time through a 3-stage ring of shared
// memory filled by cp.async, 16 bytes per copy. Since I % 16 == 0 every
// 16-byte chunk of a K row lies inside one (r, s) tap, so a chunk whose
// input pixel falls in the padding, or whose row or K index is past the
// end, is zero-filled by cp.async (src-size 0). Rows are padded to 80 bytes
// so that the 32-bit fragment loads of mma.sync.m16n8k32.s8 hit 32 distinct
// banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3, THREADS = 256;
constexpr int LDS = BK + 16;  // padded row stride in bytes
constexpr int A_STAGE = BM * LDS, B_STAGE = BN * LDS;
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE);  // 61,440

struct ConvArgs {
  const int8_t* x;       // (N, H, W, I)
  const int8_t* w;       // (O, kh, kw, I) = (O, K)
  const float* ascale;   // (N,)
  const float* wscale;   // (O,)
  void* out;             // (N, Ho, Wo, O)
  int H, W, I, Ho, Wo, O, kw, pad, M, K, out_mode;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// Copy the K slice [k0, k0 + 64) of the A tile (rows = output pixels,
// gathered from the input) and the B tile (rows = output channels) into one
// stage of shared memory: 16-byte chunk kc of rows tid/4 and tid/4 + 64.
__device__ __forceinline__ void load_stage(const ConvArgs& a, int8_t* As, int8_t* Bs, int k0,
                                           int tid, int n0, const int* a_img, const int* a_oh,
                                           const int* a_ow, const bool* a_ok) {
  const int kc = tid & 3;
  const int k = k0 + kc * 16;
  const bool kok = k < a.K;
  const int tap = kok ? k / a.I : 0;
  const int c = k - tap * a.I;
  const int r = tap / a.kw;
  const int s = tap - r * a.kw;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = (tid >> 2) + i * 64;
    const int ih = a_oh[i] + r - a.pad, iw = a_ow[i] + s - a.pad;
    const bool ok = kok && a_ok[i] && ih >= 0 && ih < a.H && iw >= 0 && iw < a.W;
    const int8_t* src = ok ? a.x + (((size_t)a_img[i] * a.H + ih) * a.W + iw) * a.I + c : a.x;
    cp_async16(As + row * LDS + kc * 16, src, ok);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = (tid >> 2) + i * 64;
    const int o = n0 + row;
    const bool ok = kok && o < a.O;
    const int8_t* src = ok ? a.w + (size_t)o * a.K + k : a.w;
    cp_async16(Bs + row * LDS + kc * 16, src, ok);
  }
}

__global__ void __launch_bounds__(THREADS) int8_conv_kernel(const ConvArgs a) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* As = smem;
  int8_t* Bs = smem + STAGES * A_STAGE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows wm*64.., cols wn*32..
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int HoWo = a.Ho * a.Wo;

  // the output pixels of the two A rows this thread copies
  int a_img[2], a_oh[2], a_ow[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + (tid >> 2) + i * 64;
    a_ok[i] = m < a.M;
    const int mm = a_ok[i] ? m : 0;
    a_img[i] = mm / HoWo;
    const int rem = mm - a_img[i] * HoWo;
    a_oh[i] = rem / a.Wo;
    a_ow[i] = rem - a_oh[i] * a.Wo;
  }

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int KT = (a.K + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < KT)
      load_stage(a, As + st * A_STAGE, Bs + st * B_STAGE, st * BK, tid, n0, a_img, a_oh, a_ow,
                 a_ok);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; every warp is done with stage kt-1
    const int nk = kt + STAGES - 1;
    if (nk < KT)
      load_stage(a, As + (nk % STAGES) * A_STAGE, Bs + (nk % STAGES) * B_STAGE, nk * BK, tid,
                 n0, a_img, a_oh, a_ow, a_ok);
    cp_async_commit();
    const int8_t* A = As + (kt % STAGES) * A_STAGE;
    const int8_t* B = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* p = A + (wm * 64 + mi * 16 + g) * LDS + kk + 4 * t;
        af[mi][0] = lds32(p);
        af[mi][1] = lds32(p + 8 * LDS);
        af[mi][2] = lds32(p + 16);
        af[mi][3] = lds32(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = B + (wn * 32 + ni * 8 + g) * LDS + kk + 4 * t;
        bf[ni][0] = lds32(p);
        bf[ni][1] = lds32(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
  }
  cp_async_wait<0>();

  // Epilogue: fragment element e of tile (mi, ni) is row g + 8 * (e / 2),
  // column 2 t + e % 2. O % 16 == 0, so a column pair is in or out together.
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 64 + mi * 16 + g + half * 8;
      if (m >= a.M) continue;
      const float as = a.out_mode ? a.ascale[m / HoWo] : 0.f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int o = n0 + wn * 32 + ni * 8 + 2 * t;
        if (o >= a.O) continue;
        const int v0 = acc[mi][ni][2 * half], v1 = acc[mi][ni][2 * half + 1];
        const size_t off = (size_t)m * a.O + o;
        if (a.out_mode == 0) {
          *reinterpret_cast<int2*>(static_cast<int*>(a.out) + off) = make_int2(v0, v1);
        } else {
          const float f0 = __fmul_rn((float)v0, __fmul_rn(as, a.wscale[o]));
          const float f1 = __fmul_rn((float)v1, __fmul_rn(as, a.wscale[o + 1]));
          if (a.out_mode == 1)
            *reinterpret_cast<float2*>(static_cast<float*>(a.out) + off) = make_float2(f0, f1);
          else
            *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.out) + off) =
                __floats2bfloat162_rn(f0, f1);
        }
      }
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. The caller (ops/quant.py)
// validates shapes (I % 16 == 0, O % 16 == 0, stride 1), types, contiguity
// and 16-byte alignment, lays the weights out as (O, kh, kw, I) and
// allocates the output. Returns the first CUDA error code, 0 on success.
extern "C" int fh_int8_conv_forward(const void* x, const void* w, const float* ascale,
                                    const float* wscale, void* out, int N, int H, int W,
                                    int I, int O, int kh, int kw, int pad, int out_mode,
                                    void* stream) {
  // the shared-memory limit is an attribute of each device: set it once per
  // device the process launches on
  static bool configured[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !configured[dev]) {
    err = cudaFuncSetAttribute(int8_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) configured[dev] = true;
  }
  ConvArgs a;
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.ascale = ascale;
  a.wscale = wscale;
  a.out = out;
  a.H = H;
  a.W = W;
  a.I = I;
  a.Ho = H + 2 * pad - kh + 1;
  a.Wo = W + 2 * pad - kw + 1;
  a.O = O;
  a.kw = kw;
  a.pad = pad;
  a.M = N * a.Ho * a.Wo;
  a.K = kh * kw * I;
  a.out_mode = out_mode;
  const dim3 grid((a.M + BM - 1) / BM, (O + BN - 1) / BN);
  int8_conv_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
