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
// overflow: 127^2 * 9 * 2048 < 2^31, and integer addition is exact in any
// order, so split-K sums equal unsplit ones bitwise.
//
// Bound: tensor-core operations at the large shapes. The largest call, the
// 256 px decoder 3x3 conv 512 -> 256 at batch 8, is 1.24e12 int8 operations,
// 0.625 ms at the H100's 1,979 dense int8 TOP/s; its operands are 0.27 GB.
//
// Design: an implicit GEMM, M = n*Ho*Wo output pixels, N = O output
// channels, K = kh*kw*I, never materialising the im2col (2.4 GB for the
// largest call). Both operands are K-major, as 8-bit wgmma needs: a row of
// A is an output pixel's (r, s, I) patch, with I contiguous in NHWC, and B
// is the (O, kh, kw, I) = (O, K) weight laid out once per weight by the
// caller. The launch is persistent: one block per SM walks work units, a
// unit being one K split of one 128 x BN output tile (BN = 256 or 128, and
// the grid, min(units, SMs), chosen by the caller's planner from the
// device's SM count), with three warpgroups:
// - two consumer warpgroups, 64 rows each, issue
//   wgmma.mma_async.m64nBNk32.s32.s8.s8 with both operands in shared memory
//   and the sums in s32 registers (setmaxnreg raises them to 224);
// - one producer warpgroup (setmaxnreg lowers it to 56) keeps a ring of
//   4 (BN 256) or 6 (BN 128) stages full. A stage is 128 bytes of K, one
//   128-byte swizzle row: B arrives by TMA from a 2-D tensor map over
//   (O, K) with 128B swizzle, zero-filled past O and past K (encoded once
//   per weight and tile width, fh_int8_conv_weight_map, and kept by the
//   caller, so a call encodes nothing); A is gathered
//   with 16-byte cp.async chunks written at their swizzled addresses,
//   zero-filled (src-size 0) in the padding and past M or K. Since
//   I % 16 == 0 a chunk lies in one (r, s) tap. Each producer thread owns
//   one chunk column and 8 rows: the rows' pixel offsets are computed once
//   per tile, the tap once per stage. Eight neighbouring threads copy one
//   row's 128 contiguous bytes, so a warp reads whole cache lines. A
//   gather rather than TMA's im2col mode: one path serves every I % 16 == 0,
//   where a 128-byte stage spans several taps when I < 128 (the 32 px
//   model's I = 32 and 64, the tests' 16, 48, 80), which an im2col box of
//   one tap's channels does not, and the gather costs the producer
//   warpgroup's threads, not the consumers'.
// - Full and empty mbarriers per stage: the producer's cp.asyncs arrive
//   with cp.async.mbarrier.arrive.noinc, the TMA with complete_tx; the
//   consumers release a stage once the wgmma group reading it has retired
//   (wgmma.wait_group 1 keeps one group in flight). The ring runs on from
//   unit to unit, so the next unit's first stages load while the consumers
//   store this one's tile.
// - The epilogue stages each warp's fragments through 2.3 KB of shared
//   memory of its own, 128 bytes of columns at a time, so that the output
//   leaves in whole 16-byte chunks of 128-byte row segments rather than in
//   4- or 8-byte pieces of half-written sectors; the scales are loaded once
//   per column pair and row.
// What this does about the mma.sync kernel it replaces: wgmma reads its
// operands from shared memory itself (no per-fragment ld.shared), one warp
// group gathers while two multiply, the K step is 128 bytes with 4-6 stages
// and no __syncthreads in the main loop, blocks start once per SM rather
// than once per tile, and small layers split K.
// Split-K: the caller's planner (ops/quant.py, int8_conv_plan) cuts the
// 128-byte K blocks into `splits` ranges, split z taking blocks
// [z*KB/splits, (z+1)*KB/splits), when the tiles alone would leave the SMs
// under-filled (the 8 and 16 px layers). Split z stores its int32 partial
// sums with plain stores into slab z of a workspace (no atomics, nothing to
// zero); a small kernel then adds the slabs in order and writes the int32
// sums or the dequantised output.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int BM = 128;        // output pixels per tile, 64 per consumer warpgroup
constexpr int BK = 128;        // K bytes per stage: one 128-byte swizzle row
constexpr int CONSUMERS = 2;   // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
// the epilogue's staging buffer: 16 rows of 128 bytes per consumer warp,
// each row padded by 16 bytes so that neither its writes nor its reads
// conflict on banks
constexpr int EPI_ROW = 144, EPI_WARP_BYTES = 16 * EPI_ROW;
constexpr int BAR_BYTES = 128;  // a full and an empty barrier per stage, up to 8 stages

template <int BN>
struct Tile {
  static constexpr int STAGES = BN == 256 ? 4 : 6;
  static constexpr int A_BYTES = BM * BK, B_BYTES = BN * BK;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // the ring, its barriers, the staging buffers, and 1 KB of slack to align
  // the ring to the 1024-byte swizzle atom
  static constexpr int SMEM =
      STAGES * STAGE_BYTES + BAR_BYTES + CONSUMERS * 4 * EPI_WARP_BYTES + 1024;
  static_assert(2 * STAGES * 8 <= BAR_BYTES, "barriers overflow their room");
};

struct ConvArgs {
  const int8_t* x;       // (N, H, W, I)
  const float* ascale;   // (N,)
  const float* wscale;   // (O,)
  void* out;             // (N, Ho, Wo, O), written directly when splits == 1
  int* ws;               // split-K partial sums, one (N, Ho, Wo, O) int32 slab per split
  int H, W, I, Ho, Wo, O, kw, pad, M, K, out_mode, k_blocks, splits, m_tiles, n_tiles;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// arrive on `bar` once every cp.async this thread issued so far has landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows with 128B swizzle:
// 8-row atoms 1024 bytes apart (SBO); LBO is unused for this layout
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_acc(int* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x N s32, the wgmma accumulator layout) = A (64 x 32) * B (N x 32)^T,
// plus d where `accumulate` is not 0
template <int N>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t da, uint64_t db, int accumulate);

template <>
__device__ __forceinline__ void wgmma_s8<128>(int* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

// One consumer warp's share of a tile's epilogue: its 16 rows (from m_warp)
// by the tile's BN columns (from n0), written to `dst` as int32 sums (mode
// 0), or as f32(acc) * (as * wscale[o]) in f32 (mode 1) or bf16 (mode 2),
// where as is as0 on the thread's first row and as1 on its second. EB is
// the output's element bytes. Accumulator 4 j + 2 h + e of a thread is row
// lane / 4 + 8 h of the warp's 16, column 8 j + 2 (lane % 4) + e. The
// fragments go through the warp's staging buffer 128 bytes of columns at a
// time, so that each store is a whole 16-byte chunk and each warp store
// covers four rows' 128 contiguous bytes. O % 16 == 0, so a chunk is in or
// out of the output whole.
template <int BN, int EB>
__device__ __forceinline__ void store_tile(const int* acc, uint8_t* buf, const ConvArgs& a,
                                           void* dst, int mode, int m_warp, int n0, int lane,
                                           float as0, float as1) {
  constexpr int CW = 128 / EB;  // columns per pass
  const int rr = lane >> 2, cc = 2 * (lane & 3);
#pragma unroll
  for (int c = 0; c < BN / CW; ++c) {
    const int cb = n0 + c * CW;
    if (cb >= a.O) break;
#pragma unroll
    for (int jj = 0; jj < CW / 8; ++jj) {
      const int j = c * (CW / 8) + jj, o = cb + 8 * jj + cc;
      float w0 = 0.f, w1 = 0.f;
      if (mode != 0 && o < a.O) {
        w0 = __ldg(a.wscale + o);
        w1 = __ldg(a.wscale + o + 1);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        const float as = h ? as1 : as0;
        uint8_t* p = buf + (rr + 8 * h) * EPI_ROW + (8 * jj + cc) * EB;
        if (EB == 2)
          *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(
              __fmul_rn((float)v0, __fmul_rn(as, w0)), __fmul_rn((float)v1, __fmul_rn(as, w1)));
        else if (mode == 1)
          *reinterpret_cast<float2*>(p) = make_float2(__fmul_rn((float)v0, __fmul_rn(as, w0)),
                                                      __fmul_rn((float)v1, __fmul_rn(as, w1)));
        else
          *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
      }
    }
    __syncwarp();
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int r = 4 * it + (lane >> 3), q = lane & 7;
      const int m = m_warp + r, o = cb + q * (16 / EB);
      if (m < a.M && o < a.O)
        *reinterpret_cast<int4*>(static_cast<uint8_t*>(dst) + ((size_t)m * a.O + o) * EB) =
            *reinterpret_cast<const int4*>(buf + r * EPI_ROW + 16 * q);
    }
    __syncwarp();  // the buffer is read before the next pass overwrites it
  }
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    int8_conv_kernel(const __grid_constant__ CUtensorMap wmap, const ConvArgs a) {
  using T = Tile<BN>;
  constexpr int STAGES = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = ring + STAGES * T::STAGE_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  const int tiles = a.m_tiles * a.n_tiles, units = tiles * a.splits;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 128 + 1);        // the producers' cp.asyncs + the TMA's expect_tx
      mbar_init(empty(s), CONSUMERS * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Persistent: block b takes work units b, b + gridDim.x, ...; unit u is
  // K split u / tiles of tile u % tiles (row tile t / n_tiles, column tile
  // t % n_tiles). The ring runs on across units, so the producer loads the
  // next unit's first stages while the consumers store this one's.
  if (tid >= CONSUMERS * 128) {
    // ---- producer warpgroup: B by TMA, A by gather ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int pt = tid - CONSUMERS * 128;
    const int c = pt & 7, r0 = pt >> 3;  // chunk column; rows r0 + 16 j
    const int HoWo = a.Ho * a.Wo;
    // row r0 + 16 j has r0's swizzle phase: chunk c sits at c ^ (r0 % 8)
    const uint32_t dst0 = r0 * BK + ((c ^ (r0 & 7)) << 4);
    int g = 0;  // stages this block has filled
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int z = u / tiles, t = u - z * tiles;
      const int n0 = (t % a.n_tiles) * BN, m0 = (t / a.n_tiles) * BM;
      const int kb0 = (int)((long long)z * a.k_blocks / a.splits);
      const int kb1 = (int)((long long)(z + 1) * a.k_blocks / a.splits);
      int base[8], ohow[8];
      unsigned valid = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int m = m0 + r0 + 16 * j;
        base[j] = 0;
        ohow[j] = 0;
        if (m < a.M) {
          const int img = m / HoWo, rem = m - img * HoWo;
          const int oh = rem / a.Wo, ow = rem - oh * a.Wo;
          base[j] = ((img * a.H + oh) * a.W + ow) * a.I;
          ohow[j] = (oh << 16) | ow;
          valid |= 1u << j;
        }
      }
      for (int kb = kb0; kb < kb1; ++kb, ++g) {
        const int s = g % STAGES;
        mbar_wait(empty(s), ((g / STAGES) & 1) ^ 1);
        const uint32_t sa = ring + s * T::STAGE_BYTES;
        if (pt == 0) {
          mbar_arrive_expect_tx(full(s), T::B_BYTES);
          tma_load_2d(sa + T::A_BYTES, &wmap, full(s), kb * BK, n0);
        }
        const int k = kb * BK + c * 16;
        const bool kok = k < a.K;
        const int tap = kok ? k / a.I : 0;
        const int r = tap / a.kw;
        const int dr = r - a.pad, ds = tap - r * a.kw - a.pad;
        const int delta = (dr * a.W + ds) * a.I + (k - tap * a.I);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int ih = (ohow[j] >> 16) + dr, iw = (ohow[j] & 0xffff) + ds;
          const bool ok = kok && ((valid >> j) & 1u) && (unsigned)ih < (unsigned)a.H &&
                          (unsigned)iw < (unsigned)a.W;
          cp_async16(sa + dst0 + j * 16 * BK, a.x + (ok ? base[j] + delta : 0), ok);
        }
        cp_async_arrive(full(s));
      }
    }
  } else {
    // ---- consumer warpgroups: wgmma on the stages that have landed ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    constexpr int R = BN / 2;
    const int wg = tid >> 7, lane = tid & 31;
    const int HoWo = a.Ho * a.Wo;
    // this warp's staging buffer, after the ring and its barriers
    uint8_t* epi =
        smem_raw + (bars + BAR_BYTES - smem_u32(smem_raw)) + (tid >> 5) * EPI_WARP_BYTES;
    int acc[R];  // each unit's first wgmma overwrites it (every unit has a K block)
    int g = 0;   // stages this block has consumed
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int z = u / tiles, t = u - z * tiles;
      const int n0 = (t % a.n_tiles) * BN, m0 = (t / a.n_tiles) * BM;
      const int nk = (int)((long long)(z + 1) * a.k_blocks / a.splits) -
                     (int)((long long)z * a.k_blocks / a.splits);
      for (int it = 0; it < nk; ++it, ++g) {
        const int s = g % STAGES;
        mbar_wait(full(s), (g / STAGES) & 1);
        // the producers' cp.async writes are generic-proxy stores; wgmma
        // reads through the async proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        const uint32_t sa = ring + s * T::STAGE_BYTES;
        const uint64_t da = sw128_desc(sa + wg * 64 * BK), db = sw128_desc(sa + T::A_BYTES);
        fence_acc<R>(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          wgmma_s8<BN>(acc, da + 2 * kk, db + 2 * kk, it > 0 || kk > 0);
        wgmma_commit();
        fence_acc<R>(acc);
        wgmma_wait<1>();  // the previous stage's group has retired: release it
        if (it > 0 && lane == 0) mbar_arrive(empty((g - 1) % STAGES));
      }
      wgmma_wait<0>();
      fence_acc<R>(acc);
      if (lane == 0) mbar_arrive(empty((g - 1) % STAGES));  // the unit's last stage

      // Epilogue: a split's int32 partial sums into its workspace slab, or
      // the whole sum's output, each warp its 16 rows.
      const int m_warp = m0 + wg * 64 + ((tid & 127) >> 5) * 16;
      const int mode = a.splits > 1 ? 0 : a.out_mode;
      float as0 = 0.f, as1 = 0.f;
      if (mode != 0) {
        const int m = m_warp + (lane >> 2);
        if (m < a.M) as0 = __ldg(a.ascale + m / HoWo);
        if (m + 8 < a.M) as1 = __ldg(a.ascale + (m + 8) / HoWo);
      }
      void* dst = a.splits > 1 ? static_cast<void*>(a.ws + (size_t)z * a.M * a.O) : a.out;
      if (mode == 2)
        store_tile<BN, 2>(acc, epi, a, dst, mode, m_warp, n0, lane, as0, as1);
      else
        store_tile<BN, 4>(acc, epi, a, dst, mode, m_warp, n0, lane, as0, as1);
    }
  }
}

// The split-K epilogue: the slabs added in order, then the int32 sums or
// the dequantised output, four outputs of one row per thread (O % 16 == 0).
__global__ void int8_conv_splitk_epilogue(const int* ws, int splits, const float* ascale,
                                          const float* wscale, void* out, long long total4,
                                          int O, int HoWo, int out_mode) {
  const int4* slabs = reinterpret_cast<const int4*>(ws);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total4;
       i += (long long)gridDim.x * blockDim.x) {
    int4 v = slabs[i];
    for (int z = 1; z < splits; ++z) {
      const int4 u = slabs[i + z * total4];
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    if (out_mode == 0) {
      reinterpret_cast<int4*>(out)[i] = v;
      continue;
    }
    const long long idx = 4 * i;
    const int m = (int)(idx / O), o = (int)(idx - (long long)m * O);
    const float as = ascale[m / HoWo];
    const float f0 = __fmul_rn((float)v.x, __fmul_rn(as, wscale[o]));
    const float f1 = __fmul_rn((float)v.y, __fmul_rn(as, wscale[o + 1]));
    const float f2 = __fmul_rn((float)v.z, __fmul_rn(as, wscale[o + 2]));
    const float f3 = __fmul_rn((float)v.w, __fmul_rn(as, wscale[o + 3]));
    if (out_mode == 1) {
      reinterpret_cast<float4*>(out)[i] = make_float4(f0, f1, f2, f3);
    } else {
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(out) + 2 * i;
      p[0] = __floats2bfloat162_rn(f0, f1);
      p[1] = __floats2bfloat162_rn(f2, f3);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so that
// the library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// error codes of the entry points beside CUDA's own (all positive)
constexpr int ERR_NO_ENCODER = -1, ERR_TENSOR_MAP = -2, ERR_PLAN = -3;

template <int BN>
int launch(const ConvArgs& a, const CUtensorMap& map, int grid, cudaStream_t stream) {
  // the shared-memory limit is an attribute of each device: set it once
  // per device the process launches on
  static bool configured[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return ERR_PLAN;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(int8_conv_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Tile<BN>::SMEM);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  int8_conv_kernel<BN><<<grid, THREADS, Tile<BN>::SMEM, stream>>>(map, a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes (ops/quant.py).
//
// The weights' tensor map, encoded once per weight and tile width by the
// caller, which keeps it with the weight: a 2-D map over the (O, K) int8
// weights `w` (K = kh*kw*I contiguous), boxes of 128 bytes of K by `bn`
// rows, 128B swizzle, zero fill out of bounds. Writes the 128-byte
// CUtensorMap to `map_out`; returns 0 or a negative code of this file.
extern "C" int fh_int8_conv_weight_map(const void* w, int O, int K, int bn, void* map_out) {
  if (bn != 128 && bn != 256) return ERR_PLAN;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_ENCODER;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)O};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {BK, (cuuint32_t)bn}, elem[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return ERR_TENSOR_MAP;
  memcpy(map_out, &map, sizeof map);
  return 0;
}

// One K3 call. The caller validates shapes (I % 16 == 0, O % 16 == 0,
// stride 1), types, contiguity and 16-byte alignment, lays the weights out
// as (O, kh, kw, I), plans the cut and allocates the output and, for
// splits > 1, the workspace `ws` of `splits` int32 slabs of the output's
// size. `shape` is {N, H, W, I, O, kh, kw, pad, bn, splits, grid}: the
// input and weight shapes, the tile width (256 or 128), the K splits and
// the persistent grid (min(units, SMs)); `wmap` the weights' map from
// fh_int8_conv_weight_map at that tile width. Returns 0 on success, else
// the first CUDA error code or a negative code of this file.
extern "C" int fh_int8_conv_forward(const int* shape, const void* wmap, const void* x,
                                    const float* ascale, const float* wscale, void* out, void* ws,
                                    int out_mode, void* stream_ptr) {
  const int N = shape[0], H = shape[1], W = shape[2], I = shape[3], O = shape[4], kh = shape[5],
            kw = shape[6], pad = shape[7], bn = shape[8], splits = shape[9], grid = shape[10];
  ConvArgs a;
  a.x = static_cast<const int8_t*>(x);
  a.ascale = ascale;
  a.wscale = wscale;
  a.out = out;
  a.ws = static_cast<int*>(ws);
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
  a.k_blocks = (a.K + BK - 1) / BK;
  a.splits = splits;
  a.n_tiles = (O + bn - 1) / bn;
  a.m_tiles = (a.M + BM - 1) / BM;
  if (splits < 1 || splits > a.k_blocks || (splits > 1 && ws == nullptr) || grid < 1)
    return ERR_PLAN;
  CUtensorMap map;  // the kernel takes it by value, from a 64-byte aligned copy
  memcpy(&map, wmap, sizeof map);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int err;
  if (bn == 256)
    err = launch<256>(a, map, grid, stream);
  else if (bn == 128)
    err = launch<128>(a, map, grid, stream);
  else
    return ERR_PLAN;
  if (err != 0 || splits == 1) return err;
  const long long total4 = (long long)a.M * O / 4;
  const int blocks = (int)((total4 + 255) / 256 < 65535 ? (total4 + 255) / 256 : 65535);
  int8_conv_splitk_epilogue<<<blocks, 256, 0, stream>>>(a.ws, splits, ascale, wscale, out,
                                                        total4, O, a.Ho * a.Wo, out_mode);
  return (int)cudaGetLastError();
}
