// W4A16 fused dequant matmul: y[M, N] = x[M, K] @ ((q - 8) * d).
//
// Replaces: tinychatengine_tpu/ops/int4_matmul.py · int4_matmul
// (body _int4_matmul_kernel, pallas_call sites :239 and :299).
//
// Layout: QM_TPU packed weights [K/2, N] uint8 read as they are stored (no
// repack): in superblock s, byte row i holds w[s*256 + i] in the low nibble
// and w[s*256 + 128 + i] in the high nibble. Scales [K/G, N], bf16 or f32.
// A layer-stacked [L, K/2, N] buffer is addressed by a pointer offset that
// the wrapper computes, so no per-layer copy is made.
//
// Two routes; the wrapper's ``int4_route`` picks one from M alone and
// passes it as ``bands`` (0 for the tile route):
//
// M <= 8, the band route: memory-bound (the N * K / 2 weight bytes over
// 3.35 TB/s; a weight byte feeds at most 16 multiply-adds). The split-K
// band contraction of csrc/int4_band.cuh on the CUDA cores: one block per
// (128 columns, the rows, a band of whole superblocks), f32 band sums
// added in K order by a second kernel. The wrapper picks the
// band from K and N (never from M) so that at least two blocks per SM
// stream the weight; an unstacked weight (the lm_head, [2048, 129024]
// bytes) is one layer at offset 0. The TPU kernel's cast point: the exact
// codes, times the f32 scale once per 16 rows.
//
// M >= 9, the tile route: bound by operations (2 * M * N * K) from some
// hundred rows up. Hopper tensor cores: a 128 x 128 output tile per block,
// two consumer warpgroups of 64 rows each issuing wgmma.mma_async
// m64n128k16 (bf16 x bf16 -> f32 in registers) and a producer warp that
// brings x in by TMA (128-byte swizzle; rows past M are zero-filled) into a
// ring of 4 stages guarded by mbarriers. A stage is 64 packed byte rows:
// superblock s, half h, holding both nibble planes, k = 256 s + 64 h + i
// (low) and k + 128 (high). Each byte is read from device memory once per
// block (the first version read it once per plane), straight into
// registers a stage ahead, and the 256 consumer threads dequantize it into
// two bf16 B tiles ([128 n][64 k], K-major, written in the swizzled layout
// that wgmma reads), double-buffered so that the tensor cores run stage i
// while the CUDA cores dequantize stage i + 1. The B operand is
// bf16((q - 8) * d) in f32, the plain version's cast point
// (int4_matmul_xla): one accumulator set, the dequantization spread over
// the tile's 128 rows. The TPU kernel's per-group fold (exact codes, then
// (dot - 8 sum x) * d once per group) would need a second accumulator set
// and a wgmma wait per group, halving the tile and stalling the pipe. A
// 128 x 256 tile (m64n256k16) was tried and dropped: at the 168 registers
// a thread of this block gets, its 128 accumulators spilled and it ran
// slower than 128 x 128 at every shape timed.
//
// Determinism, within a route only: an output row's bits depend on its x
// row (and the weights) alone, not on M, on the tile the row falls in or on
// the other rows: rows never mix in the tile route's accumulators, and the
// band route's partition depends on K and N only. The two routes compute
// at different cast points, so a row's bits change where M crosses from 8
// to 9. The chunked prefills that must give the same tokens with and
// without a prefix-cache hit rely on this within a route; a hit whose
// uncached tail is 8 rows or fewer, against a chunk of 9 or more, is not
// covered.

#include <cuda.h>

#include "int4_band.cuh"

namespace {

constexpr int BM = 128, BN = 128;  // output tile
constexpr int BK = 64;             // k of one bf16 B tile (one nibble plane)
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;     // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // + the producer's warp

struct alignas(1024) TileSmem {
  // x tiles [stage][plane][128 rows][64 k], 128-byte swizzle (TMA)
  __nv_bfloat16 a[STAGES][2][BM * BK];
  // dequantized weights [buffer][plane][128 n][64 k], the same swizzle
  __nv_bfloat16 b[2][2][BN * BK];
  uint64_t full[STAGES], empty[STAGES];
};
constexpr int SMEM_BYTES = sizeof(TileSmem) + 1024;  // + base alignment

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// waits for the phase of ``parity`` to complete; a pipeline fault that
// would wait forever traps (a launch error) after some seconds instead
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (spins == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// a [rows][64 bf16] box of the 2-D tensor map at (k, row) into dst
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k),
      "r"(row)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// a K-major operand of 8-row, 128-byte swizzled atoms (1024 bytes apart)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 16] * B[16 x 128], both K-major in shared memory
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// four scales of consecutive columns as f32
__device__ __forceinline__ void load_scales(const __nv_bfloat16* p,
                                            float (&d)[4]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  d[0] = __uint_as_float(v.x << 16);
  d[1] = __uint_as_float(v.x & 0xffff0000u);
  d[2] = __uint_as_float(v.y << 16);
  d[3] = __uint_as_float(v.y & 0xffff0000u);
}
__device__ __forceinline__ void load_scales(const float* p, float (&d)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

__device__ __forceinline__ float pick4(const float (&d)[4], int c) {
  return c == 0 ? d[0] : c == 1 ? d[1] : c == 2 ? d[2] : d[3];
}

// (code - 8) * d in f32, code in 0..15: 2^23 + code holds the code in its
// low mantissa bits, so the subtraction is exact
__device__ __forceinline__ float dequant(uint32_t code, float d) {
  return __fmul_rn(__fsub_rn(__uint_as_float(0x4B000000u | code), 8388616.f),
                   d);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// One consumer thread's share of a stage: 4 columns x 8 packed rows, the
// 32 bytes loaded a stage ahead, and the scales of its low and high plane
struct StageRegs {
  uint32_t w[8];
  float dlo[4], dhi[4];
};

template <typename ST>
__device__ __forceinline__ void load_stage(StageRegs& r, int i,
                                           const uint8_t* __restrict__ w,
                                           const ST* __restrict__ s, int N,
                                           int G, int ncol, int j, bool ok) {
  const int sb = i >> 1, half = i & 1;
  const int prow = 128 * sb + 64 * half + 8 * j;  // the first packed row
  const int klo = 256 * sb + 64 * half + 8 * j;   // its low-plane k
  if (!ok) {
#pragma unroll
    for (int e = 0; e < 8; ++e) r.w[e] = 0u;
#pragma unroll
    for (int c = 0; c < 4; ++c) r.dlo[c] = r.dhi[c] = 0.f;
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    r.w[e] = __ldg(reinterpret_cast<const uint32_t*>(
        w + (size_t)(prow + e) * N + ncol));
  load_scales(s + (size_t)(klo / G) * N + ncol, r.dlo);
  load_scales(s + (size_t)((klo + 128) / G) * N + ncol, r.dhi);
}

template <typename ST>
__global__ void __launch_bounds__(THREADS, 1) tile_kernel(
    const __grid_constant__ CUtensorMap xmap, const uint8_t* __restrict__ w,
    const ST* __restrict__ s, __nv_bfloat16* __restrict__ y, int M, int K,
    int N, int G) {
  extern __shared__ uint8_t smem_raw[];
  TileSmem& sm = *reinterpret_cast<TileSmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int n_stages = K / 128;  // 64 packed rows, both planes, a stage
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&sm.full[i], 1);
      mbar_init(&sm.empty[i], 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer: one thread issues TMA
    if (threadIdx.x == CONSUMERS) {
      for (int i = 0; i < n_stages; ++i) {
        const int slot = i % STAGES;
        if (i >= STAGES) mbar_wait(&sm.empty[slot], (i / STAGES - 1) & 1);
        mbar_expect_tx(&sm.full[slot], 2 * BM * BK * 2);
        const int k0 = 256 * (i >> 1) + 64 * (i & 1);
        tma_load(sm.a[slot][0], &xmap, &sm.full[slot], k0, m0);
        tma_load(sm.a[slot][1], &xmap, &sm.full[slot], k0 + 128, m0);
      }
    }
    return;
  }

  // consumers: thread t dequantizes columns 4 (t % 32) .. + 3 of packed
  // rows 8 (t / 32) .. + 7 of each stage; warpgroup wg owns tile rows
  // 64 wg .. 64 wg + 63
  const int t = threadIdx.x, wg = t / 128;
  const int nq = t % 32, j = t / 32;
  const int ncol = n0 + 4 * nq;
  const bool col_ok = ncol < N;
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  StageRegs cur, nxt;
  load_stage(cur, 0, w, s, N, G, ncol, j, col_ok);

  for (int i = 0; i < n_stages; ++i) {
    const int slot = i % STAGES, buf = i & 1;
    if (i + 1 < n_stages) load_stage(nxt, i + 1, w, s, N, G, ncol, j, col_ok);
    uint8_t* blo = reinterpret_cast<uint8_t*>(sm.b[buf][0]);
    uint8_t* bhi = reinterpret_cast<uint8_t*>(sm.b[buf][1]);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      // rotated so that 8 neighbouring threads store to 8 distinct
      // 16-byte chunks of the swizzle (no bank conflicts)
      const int c = (cc + (nq >> 1)) & 3;
      const int nl = 4 * nq + c;  // the column within the tile
      const float dlo = pick4(cur.dlo, c), dhi = pick4(cur.dhi, c);
      uint32_t plo[4], phi[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t b0 = cur.w[2 * e] >> (8 * c);
        const uint32_t b1 = cur.w[2 * e + 1] >> (8 * c);
        plo[e] = pack_bf16(dequant(b0 & 15u, dlo), dequant(b1 & 15u, dlo));
        phi[e] = pack_bf16(dequant((b0 >> 4) & 15u, dhi),
                           dequant((b1 >> 4) & 15u, dhi));
      }
      const int off = nl * 128 + ((j ^ (nl & 7)) << 4);
      *reinterpret_cast<uint4*>(blo + off) =
          make_uint4(plo[0], plo[1], plo[2], plo[3]);
      *reinterpret_cast<uint4*>(bhi + off) =
          make_uint4(phi[0], phi[1], phi[2], phi[3]);
    }
    // the B tiles, written by the generic proxy, are read by wgmma's
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(1, CONSUMERS);
    mbar_wait(&sm.full[slot], (i / STAGES) & 1);

    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    fence_acc(acc);
#pragma unroll
    for (int plane = 0; plane < 2; ++plane) {
      const uint32_t a0 = smem_u32(sm.a[slot][plane]) + wg * 64 * 128;
      const uint32_t b0 = smem_u32(sm.b[buf][plane]);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_m64n128k16(acc, sw128_desc(a0 + 32 * kk),
                         sw128_desc(b0 + 32 * kk));
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    fence_acc(acc);
    // stage i - 1's products are done: its x tiles go back to the
    // producer, and (after both warpgroups pass) its B buffer to stage i + 1
    if (i > 0 && t % 128 == 0) mbar_arrive(&sm.empty[(i - 1) % STAGES]);
    named_sync(2, CONSUMERS);
    cur = nxt;
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_acc(acc);

  // the accumulator fragment: row 16 warp + lane / 4 (+ 8), columns
  // 8 c + 2 (lane % 4) (+ 1) for c = 0..15
  const int lane = t % 32, warp = (t % 128) / 32;
  const int row = m0 + 64 * wg + 16 * warp + lane / 4;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const int col = n0 + 8 * c + 2 * (lane % 4);
    if (col >= N) continue;
    if (row < M)
      *reinterpret_cast<__nv_bfloat162*>(y + (size_t)row * N + col) =
          __floats2bfloat162_rn(acc[4 * c], acc[4 * c + 1]);
    if (row + 8 < M)
      *reinterpret_cast<__nv_bfloat162*>(y + (size_t)(row + 8) * N + col) =
          __floats2bfloat162_rn(acc[4 * c + 2], acc[4 * c + 3]);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <typename ST>
int launch_tile(const void* x, const void* w, const void* s, void* y, int M,
                int K, int N, int G, cudaStream_t st) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {BK, BM};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      tile_kernel<ST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  // M tiles fastest: the blocks in flight share a few weight tiles in L2
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  tile_kernel<ST><<<grid, THREADS, SMEM_BYTES, st>>>(
      map, static_cast<const uint8_t*>(w), static_cast<const ST*>(s),
      static_cast<__nv_bfloat16*>(y), M, K, N, G);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, K] bf16, 16-byte aligned (K already padded to the packed K); w
// [K/2, N] uint8; s [K/G, N] (bf16 when scale_bf16 != 0, else f32); y
// [M, N] bf16. bands > 0 takes the band route: part is f32 scratch of
// bands * M * N, K split into bands of sb_per_band superblocks; bands == 0
// the tile route (part unused). Needs K % 256 == 0, N % 4 == 0, G in
// {32, 64, 128}.
extern "C" int tce_int4_matmul(const void* x, const void* w, const void* s,
                               void* y, int M, int K, int N, int G,
                               int scale_bf16, void* part, int sb_per_band,
                               int bands, void* stream) {
  if (M < 1 || K % 256 || N % 4 || (G != 32 && G != 64 && G != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bands > 0) {
    float* p = static_cast<float*>(part);
    return scale_bf16
               ? tce::band::launch_bands<__nv_bfloat16>(
                     x, w, s, p, y, M, K, N, G, sb_per_band, bands, st)
               : tce::band::launch_bands<float>(x, w, s, p, y, M, K, N, G,
                                                sb_per_band, bands, st);
  }
  return scale_bf16 ? launch_tile<__nv_bfloat16>(x, w, s, y, M, K, N, G, st)
                    : launch_tile<float>(x, w, s, y, M, K, N, G, st);
}
