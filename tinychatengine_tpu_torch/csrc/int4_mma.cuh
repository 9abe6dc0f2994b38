// The split-K int4 contraction on the tensor cores, shared by the K-outer
// kernel, the fused decode kernel and the GLU kernel's down product at
// every row count and by the fused MLP's two products (``band_item``
// inside its persistent blocks): one work
// item computes the f32 sum of y[m, n] over a band of K (whole
// superblocks) for a tile of up to 64 rows and 128 columns and writes it to
// a [bands, M, N] scratch, as ``band_partial`` (int4_band.cuh) does on the
// CUDA cores; the caller sums the bands in K order and rounds once.
//
// Arithmetic (the TPU kernels' cast point: bf16 x, exact codes, a per-group
// f32 dot, f32 scales): the codes enter as bf16 q - 8 (exact: -8..7), each
// group's k16 steps accumulate x . (q - 8) into a fresh f32 fragment with
// mma.sync m16n8k16 (bf16 in, f32 accumulate), and at the group's end
//   acc = fma(dot, d, acc)
// folds it in with the group's f32 scale, groups in K order. The TPU's
// order, (x . q - 8 sum x) * d on raw codes, is the same function summed
// another way; q - 8 needs no row sums. A k16 step never straddles a group
// (G in 32, 64, 128 divides a plane's 128 k).
//
// Orientation: y^T = W^T x^T. Weight columns are the MMA's m16 rows (a
// warp owns 32 columns: two m16 tiles) and activation rows its n8 columns
// (a warp owns 8 NT rows), so 8 decode rows fill one n8 tile with no
// padding and a dequantized weight fragment feeds NT products. A thread
// (g = lane / 4, t = lane % 4) owns columns 4g..4g+3 of its warp's 32: tile
// 0's rows g and g + 8 are columns 4g and 4g + 1, tile 1's are 4g + 2 and
// 4g + 3. So each of its A fragments comes from the 32-bit words holding
// those four columns' bytes at packed rows 2t, 2t + 1, 2t + 8 and 2t + 9 of
// the k16 step (the fragment's k order), both nibble planes in the same
// four words: a byte permute pairs two rows, a shift, a mask and an or make
// bf16 128 + q, and one bf16x2 subtract makes q - 8.
//
// Data movement: a two-stage ring of superblocks in shared memory, each the
// packed [128, 128] slab (rows padded to 144 bytes, so the words of one
// fragment load fall in 32 distinct banks), the block's activation rows
// [MT, 256] in bf16 (rows padded to 528 bytes for conflict-free ldmatrix)
// and the superblock's scale rows, all by 16-byte cp.async, coalesced
// along N as stored; rows past M and columns past N are zero-filled.
// Superblock i + 1 is requested as superblock i is multiplied.
// x's B fragments come by ldmatrix, two k16 steps per ldmatrix.x4.
// wgmma m64n64k16 (weights from registers, x from shared memory) was
// tried for the 64-row tiles and ran no faster on the H100 (PERF.md).
//
// Determinism: a row's bits depend on its own x row, K, N and the band
// width, never on M or on the row tile it falls in (rows never mix in an
// MMA, and the k order, the fold order and the band order are fixed).
#pragma once

#include "common.cuh"

namespace tce {
namespace mma4 {
// internal linkage: each library that includes this header keeps its own
// kernels and its own once-only launch settings (an inline function's
// static is otherwise one object across every library loaded)
namespace {

constexpr int SB = 256;     // K rows per superblock
constexpr int PLANE = 128;  // packed rows per superblock

// four warps side by side, each 32 columns by the block's 8 NT rows; a
// ring of two stages, each [x][weights][scales]. Two stages let four blocks
// share an SM at 8 rows; three or four stages, 256 columns or two warps
// down the rows measured no faster (PERF.md). At 64 rows the x loader is
// left rolled (ROLL_X): unrolled, its 16 copy addresses stay live and push
// the 128 sums into local memory.
template <int NT>
struct Cfg {
  static constexpr int STAGES = 2;
  static constexpr bool ROLL_X = NT == 8;
  static constexpr int THREADS = 128;
  static constexpr int BN = 128;           // columns per block
  static constexpr int MT = 8 * NT;        // rows per block
  static constexpr int WS = BN + 16;       // bytes per staged packed row
  static constexpr int XS = SB + 8;        // bf16 per staged x row
  static constexpr int W_OFF = MT * XS * 2;
  static constexpr int S_OFF = W_OFF + PLANE * WS;
  static constexpr int STAGE = S_OFF + (SB / 32) * BN * 4;  // 8 f32 rows
  static constexpr int SMEM = STAGES * STAGE;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !pred
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the nibbles at bits 0-3 and 16-19 of u as a bf16 pair q - 8, exactly:
// (u & 0x000F000F) | 0x43004300 in one lop3 (nvcc splits the C form in two,
// one immediate an instruction) is bf16 128 + q, minus bf16 136 (0x4308)
__device__ __forceinline__ uint32_t codes_q8(uint32_t u) {
  uint32_t v;
  asm("lop3.b32 %0, %1, %2, %3, 0xea;"  // (a & b) | c
      : "=r"(v)
      : "r"(u), "r"(0x000F000Fu), "r"(0x43004300u));
  const uint32_t c = 0x43084308u;
  __nv_bfloat162 h = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                             *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void load_scales(const float* p, float (&d)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
}

__device__ __forceinline__ void load_scales(const __nv_bfloat16* p,
                                            float (&d)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  d[0] = __low2float(lo), d[1] = __high2float(lo);
  d[2] = __low2float(hi), d[3] = __high2float(hi);
}

// superblock sb's weight slab and scale rows into one ring stage: every
// loop has a trip count known at compile time, so the per-thread offsets
// and predicates are computed once per block
template <typename ST, int G, class C>
__device__ __forceinline__ void load_weights(uint8_t* st,
                                             const uint8_t* __restrict__ w,
                                             const ST* __restrict__ s, int N,
                                             int n0, int sb) {
  const int tid = threadIdx.x;
  constexpr int WCH = C::BN / 16;  // 16-byte chunks of a packed row
  static_assert(PLANE * WCH % C::THREADS == 0, "whole weight chunks");
#pragma unroll
  for (int j = 0; j < PLANE * WCH / C::THREADS; ++j) {
    const int i = tid + j * C::THREADS;
    const int r = i / WCH, c = i % WCH;
    const bool in = n0 + c * 16 < N;
    cp_async16(smem_u32(st + C::W_OFF + r * C::WS + c * 16),
               w + (size_t)(sb * PLANE + r) * N + (in ? n0 + c * 16 : 0), in);
  }
  uint8_t* ss = st + C::S_OFF;
  constexpr int PER = 16 / sizeof(ST);  // scale columns per chunk
  constexpr int SCH = C::BN / PER;
  constexpr int SN = SB / G * SCH;
#pragma unroll
  for (int j = 0; j < (SN + C::THREADS - 1) / C::THREADS; ++j) {
    const int i = tid + j * C::THREADS;
    const int r = i / SCH, c = i % SCH;
    const bool in = n0 + c * PER < N;
    if (i < SN)
      cp_async16(smem_u32(ss + (r * C::BN + c * PER) * sizeof(ST)),
                 s + (size_t)(sb * SB / G + r) * N + (in ? n0 + c * PER : 0),
                 in);
  }
}

// the block's x rows of superblock sb into one ring stage (the loop of a
// 64-row tile is left rolled: see Cfg)
template <class C>
__device__ __forceinline__ void load_x(uint8_t* st,
                                       const __nv_bfloat16* __restrict__ x,
                                       int M, int K, int m0, int sb) {
  const int tid = threadIdx.x;
  constexpr int XCH = SB / 8;  // 16-byte chunks of a staged x row
  static_assert(C::MT * XCH % C::THREADS == 0, "whole x chunks");
  auto x_chunk = [&](int j) {
    const int i = tid + j * C::THREADS;
    const int r = i / XCH, c = i % XCH;
    const bool in = m0 + r < M;
    cp_async16(smem_u32(st + (r * C::XS + c * 8) * 2),
               x + (size_t)(in ? m0 + r : 0) * K + sb * SB + c * 8, in);
  };
  if constexpr (C::ROLL_X) {
#pragma unroll 1
    for (int j = 0; j < C::MT * XCH / C::THREADS; ++j) x_chunk(j);
  } else {
#pragma unroll
    for (int j = 0; j < C::MT * XCH / C::THREADS; ++j) x_chunk(j);
  }
}

// the A fragments of the k16 step at packed row r0 of one nibble plane,
// for the warp's two m16 tiles (see the head note)
template <class C>
__device__ __forceinline__ void weight_frags(const uint8_t* wcol, int r0,
                                             int t, int plane,
                                             uint32_t (&a)[2][4]) {
  const uint8_t* wr = wcol + (r0 + 2 * t) * C::WS;
  const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wr);
  const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wr + C::WS);
  const uint32_t w2 = *reinterpret_cast<const uint32_t*>(wr + 8 * C::WS);
  const uint32_t w3 = *reinterpret_cast<const uint32_t*>(wr + 9 * C::WS);
  // u: byte 2 tile + {0, 1} (the tile's two columns) of rows 2t and 2t + 1;
  // v: the same of rows 2t + 8 and 2t + 9
  const int sh = 4 * plane;
#pragma unroll
  for (int tile = 0; tile < 2; ++tile) {
    const uint32_t sel = tile ? 0x7632u : 0x5410u;
    const uint32_t u = __byte_perm(w0, w1, sel);
    const uint32_t v = __byte_perm(w2, w3, sel);
    a[tile][0] = codes_q8(u >> sh);
    a[tile][1] = codes_q8(u >> (8 + sh));
    a[tile][2] = codes_q8(v >> sh);
    a[tile][3] = codes_q8(v >> (8 + sh));
  }
}

// acc = fma(dot, d, acc) for the group ending at packed row r0 + 16 of a
// plane: tile i's rows g and g + 8 are columns 4g + 2i and 4g + 2i + 1
template <typename ST, int G, class C, int NT>
__device__ __forceinline__ void fold(float (&acc)[2][NT][4],
                                     const float (&dot)[2][NT][4],
                                     const ST* ss, int plane, int r0) {
  float d[4];
  load_scales(ss + ((plane * PLANE + r0) / G) * C::BN, d);
#pragma unroll
  for (int tile = 0; tile < 2; ++tile)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float(&c)[4] = acc[tile][nt];
      c[0] = fmaf(dot[tile][nt][0], d[2 * tile], c[0]);
      c[1] = fmaf(dot[tile][nt][1], d[2 * tile], c[1]);
      c[2] = fmaf(dot[tile][nt][2], d[2 * tile + 1], c[2]);
      c[3] = fmaf(dot[tile][nt][3], d[2 * tile + 1], c[3]);
    }
}

// one staged superblock into the warp's sums: acc[tile][nt][e] as the
// C fragments of tile (columns) by nt (rows)
template <typename ST, int G, class C, int NT>
__device__ __forceinline__ void compute_stage(const uint8_t* st,
                                              float (&acc)[2][NT][4],
                                              int warp) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const uint8_t* wcol = st + C::W_OFF + warp * 32 + 4 * g;
  const ST* ss = reinterpret_cast<const ST*>(st + C::S_OFF) + warp * 32 +
                 4 * g;
  float dot[2][NT][4];
  const uint32_t xb = smem_u32(st) +
                      ((lane & 7) * C::XS + 8 * (lane >> 3)) * 2;
#pragma unroll
  for (int plane = 0; plane < 2; ++plane) {
#pragma unroll
    for (int sp = 0; sp < PLANE / 32; ++sp) {
      uint32_t b[NT][4];  // B fragments of k16 steps 2 sp and 2 sp + 1
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        ldmatrix_x4(b[nt],
                    xb + (nt * 8 * C::XS + plane * PLANE + 32 * sp) * 2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r0 = 32 * sp + 16 * h;
        if ((r0 & (G - 1)) == 0) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) dot[i][nt][e] = 0.f;
        }
        uint32_t a[2][4];
        weight_frags<C>(wcol, r0, t, plane, a);
#pragma unroll
        for (int tile = 0; tile < 2; ++tile)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_bf16(dot[tile][nt], a[tile], b[nt][2 * h],
                     b[nt][2 * h + 1]);
        if (((r0 + 16) & (G - 1)) == 0)  // the group ends: fold it in
          fold<ST, G, C, NT>(acc, dot, ss, plane, r0);
      }
    }
  }
}

// one work item: the f32 sums of rows m0.. (at most MT) and columns n0..
// n0 + 127 over ``count`` superblocks from sb0, written to part[band]
// [M, N]. ``weights_staged``: stage 0's weights and scales are already
// requested (``load_weights``, committed) by the caller. Ends with every
// copy landed; the caller synchronises the block before it reuses smem.
template <typename ST, int G, int NT>
__device__ __forceinline__ void band_item(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
    const ST* __restrict__ s, float* __restrict__ part, int M, int K, int N,
    int m0, int n0, int sb0, int count, int band, uint8_t* smem,
    bool weights_staged = false) {
  using C = Cfg<NT>;
  constexpr int STAGES = C::STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < count) {
      if (i > 0 || !weights_staged)
        load_weights<ST, G, C>(smem + i * C::STAGE, w, s, N, n0, sb0 + i);
      load_x<C>(smem + i * C::STAGE, x, M, K, m0, sb0 + i);
    }
    cp_async_commit();
  }
  for (int i = 0; i < count; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage i landed; stage i - 1 is free again
    const int nx = i + STAGES - 1;
    if (nx < count) {
      uint8_t* st = smem + (nx % STAGES) * C::STAGE;
      load_weights<ST, G, C>(st, w, s, N, n0, sb0 + nx);
      load_x<C>(st, x, M, K, m0, sb0 + nx);
    }
    cp_async_commit();
    compute_stage<ST, G, C, NT>(smem + (i % STAGES) * C::STAGE, acc, warp);
  }
  cp_async_wait<0>();

  // row 2t + e of n8 tile nt: columns 4g .. 4g + 3 as one 16-byte store
  const int g = lane / 4, t = lane % 4;
  const int n = n0 + warp * 32 + 4 * g;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + nt * 8 + 2 * t + e;
      if (m < M && n < N)
        *reinterpret_cast<float4*>(part + ((size_t)band * M + m) * N + n) =
            make_float4(acc[0][nt][e], acc[0][nt][2 + e], acc[1][nt][e],
                        acc[1][nt][2 + e]);
    }
}

// one (128 columns, MT rows, band) item of a [N/128, M/MT, bands] grid:
// the band's sums into part[band]. PDL: the kernel is launched as a
// programmatic dependent of the kernel that writes x, so it requests its
// first superblock's weights and scales, then waits for that kernel
// (griddepcontrol.wait) before it requests x
template <typename ST, int G, int NT, bool PDL>
__global__ void __launch_bounds__(128)
    mma_band_kernel(const __nv_bfloat16* __restrict__ x,
                    const uint8_t* __restrict__ w, const ST* __restrict__ s,
                    float* __restrict__ part, int M, int K, int N,
                    int sb_per_band) {
  using C = Cfg<NT>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int sb0 = blockIdx.z * sb_per_band;
  const int n0 = blockIdx.x * C::BN;
  if constexpr (PDL) {
    load_weights<ST, G, C>(smem, w, s, N, n0, sb0);
    cp_async_commit();
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
  }
  band_item<ST, G, NT>(x, w, s, part, M, K, N, blockIdx.y * C::MT, n0, sb0,
                       min(sb_per_band, K / SB - sb0), blockIdx.z, smem, PDL);
}

// rows a block of the tensor-core route covers at M rows (the wrapper's
// ``mma_row_tile`` mirrors it): 8, 16, 32, or 64 with the rest as grid rows
inline int row_tile(int M) {
  return M <= 8 ? 8 : M <= 16 ? 16 : M <= 32 ? 32 : 64;
}

template <typename ST, int G, int NT, bool PDL>
int launch_cfg(const void* x, const void* w, const void* s, float* part,
               int M, int K, int N, int sb_per_band, int bands,
               cudaStream_t st) {
  using C = Cfg<NT>;
  auto kernel = mma_band_kernel<ST, G, NT, PDL>;
  static bool configured = false;  // once, outside any CUDA graph capture
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + C::BN - 1) / C::BN, (M + C::MT - 1) / C::MT, bands);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = PDL ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(x),
      static_cast<const uint8_t*>(w), static_cast<const ST*>(s), part, M, K,
      N, sb_per_band);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <typename ST, int G, bool PDL>
int launch_g(const void* x, const void* w, const void* s, float* part, int M,
             int K, int N, int sb_per_band, int bands, cudaStream_t st) {
  switch (row_tile(M)) {
    case 8:
      return launch_cfg<ST, G, 1, PDL>(x, w, s, part, M, K, N, sb_per_band,
                                       bands, st);
    case 16:
      return launch_cfg<ST, G, 2, PDL>(x, w, s, part, M, K, N, sb_per_band,
                                       bands, st);
    case 32:
      return launch_cfg<ST, G, 4, PDL>(x, w, s, part, M, K, N, sb_per_band,
                                       bands, st);
    default:
      return launch_cfg<ST, G, 8, PDL>(x, w, s, part, M, K, N, sb_per_band,
                                       bands, st);
  }
}

// the band sums of x [M, K] @ W into part [bands, M, N]; x 16-byte
// aligned, w and s 16-byte aligned, K % 256 == 0, N % 16 == 0, G in {32,
// 64, 128}. PDL: launched as a programmatic dependent of the kernel that
// writes x (see mma_band_kernel). Returns cudaGetLastError()
template <typename ST, bool PDL = false>
int launch_mma(const void* x, const void* w, const void* s, float* part,
               int M, int K, int N, int G, int sb_per_band, int bands,
               cudaStream_t st) {
  switch (G) {
    case 32:
      return launch_g<ST, 32, PDL>(x, w, s, part, M, K, N, sb_per_band, bands,
                                   st);
    case 64:
      return launch_g<ST, 64, PDL>(x, w, s, part, M, K, N, sb_per_band, bands,
                                   st);
    default:
      return launch_g<ST, 128, PDL>(x, w, s, part, M, K, N, sb_per_band,
                                    bands, st);
  }
}

}  // namespace
}  // namespace mma4
}  // namespace tce
