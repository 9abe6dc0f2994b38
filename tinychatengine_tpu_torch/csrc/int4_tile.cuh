// The int4 tile route's pieces (csrc/int4_matmul.cu's ``tile_kernel``,
// whose note describes them), shared with the grouped expert kernel of
// csrc/int4_moe.cu: the ring of TMA stages and its barriers, the producer
// warp's copies, the consumer warpgroups' dequantization into wgmma's
// register A operand and the products, the tensor maps. Internal linkage,
// as int4_mma.cuh, so each library keeps its own once-only settings.
#pragma once

#include <cuda.h>

#include <cooperative_groups.h>

#include "common.cuh"

namespace {


constexpr int BN = 128;        // weight columns a block: two warpgroups of 64
constexpr int ROWS = 64;       // packed rows a stage (64 low-plane k, 64 high)
constexpr int CONSUMERS = 256;  // two warpgroups
// + the producer's warpgroup: one warp copies, all four give registers
// back (setmaxnreg) to the consumers' accumulators
constexpr int THREADS = CONSUMERS + 128;
constexpr int MAX_SPLIT = 8;   // the portable cluster size
constexpr int PSTRIDE = BN + 4;  // floats in a row of the block's f32 sums

// by token-tile width T: the ring's depth (as many stages as fit in about
// 110 KB, two blocks an SM, up to T = 64; in 227 KB, one block, above) and
// the registers of a consumer and a producer thread after setmaxnreg (a
// consumer holds T / 2 accumulators and two k16 steps' 16 A registers)
template <int T>
struct Cfg {
  static constexpr int STAGES =
      T == 16 ? 7 : T == 32 ? 6 : T == 64 ? 4 : T == 128 ? 5 : 3;
  static constexpr int MIN_BLOCKS = T <= 64 ? 2 : 1;
  static constexpr int CONSUMER_REGS = T <= 64 ? 104 : 232;
  static constexpr int PRODUCER_REGS = T <= 64 ? 32 : 40;
  // a thread's registers at launch (the launch bound's share, in units of
  // 8); setmaxnreg moves registers only inside a block, so what the two
  // consumer warpgroups gain the producer warpgroup must give up, or the
  // second consumer warpgroup waits for ever
  static constexpr int LAUNCH_REGS = 65536 / (THREADS * MIN_BLOCKS) / 8 * 8;
  static_assert(2 * (CONSUMER_REGS - LAUNCH_REGS) <=
                    LAUNCH_REGS - PRODUCER_REGS,
                "the consumers' registers come from the producer's");
};

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

template <int T>
struct alignas(1024) Slot {
  // x rows [plane][T][64 k], 128-byte swizzle (TMA)
  __nv_bfloat16 x[2][T * 64];
  // packed rows [64][128 columns]; 16-byte chunk q of row r stored at chunk
  // q ^ (r % 8) (TMA's 128-byte swizzle)
  uint8_t w[ROWS * BN];
  // scales [plane][group row][128 columns], bf16 or f32 (two group rows of
  // a plane at G = 32, one above)
  uint8_t sc[2][2 * BN * 4];
};

// x [M][K] bf16 (boxes of 64 k by T rows); where N % 16 == 0 also the
// layer's packed weights [K/2][N] (boxes of 128 columns by 64 rows) and
// scales [K/G][N] (boxes of 128 columns by a plane's group rows)
struct Maps {
  CUtensorMap x, w, s;
};

template <int T>
struct Ring {
  Slot<T> slot[Cfg<T>::STAGES];
  uint64_t full[Cfg<T>::STAGES], empty[Cfg<T>::STAGES];
};

template <int T>
constexpr int smem_bytes() {
  return (int)sizeof(Ring<T>) + 1024;  // + base alignment
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// waits for the phase of ``parity`` to complete; a pipeline fault that
// would wait for ever traps (a launch error) after two seconds instead
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (uint32_t spins = 1; !done; ++spins) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && spins % 1024 == 0) {
      const uint64_t now = global_ns();
      if (t0 == 0) t0 = now;
      else if (now - t0 > 2000000000ull) __trap();
    }
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

// BYTES of src into shared dst; valid < BYTES zero-fills the rest
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int valid) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
                 "l"(src), "r"(valid)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(dst),
                 "l"(src), "n"(BYTES), "r"(valid)
                 : "memory");
}

// an arrival on bar once this thread's earlier cp.async copies have landed
// (counted in the barrier's arrival count)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile(
      "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
          smem_u32(bar))
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

template <int NA>
__device__ __forceinline__ void fence_acc(float (&d)[NA]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d[64 x T] += A[64 x 16] * B[16 x T]: A from registers (the m16n8k16 A
// fragment of each warp's 16 rows), B K-major in shared memory
template <int T>
__device__ __forceinline__ void wgmma_rs(float (&d)[T / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// the codes of bits 0-3 and 16-19 of v as bf16x2 q - 8, exact: the mask
// and or (one lop3) make 128 + q, the fma subtracts 136
__device__ __forceinline__ uint32_t codes(uint32_t v) {
  uint32_t b;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;"
      : "=r"(b)
      : "r"(v), "r"(0x000F000Fu), "r"(0x43004300u));
  return bf16x2_fma(b, 0x3F803F80u, 0xC308C308u);  // b * 1 - 136
}

// the scales of a thread's columns (cl, cl + 1) for the low and high plane
template <typename ST>
struct Scales;

template <>
struct Scales<__nv_bfloat16> {
  uint32_t lo[2], hi[2];  // {d, d} bf16x2 of each column
  __device__ __forceinline__ void load(const uint8_t* lo_row,
                                       const uint8_t* hi_row, int cl) {
    const uint32_t l = *reinterpret_cast<const uint32_t*>(lo_row + 2 * cl);
    const uint32_t h = *reinterpret_cast<const uint32_t*>(hi_row + 2 * cl);
    lo[0] = prmt(l, l, 0x1010);
    lo[1] = prmt(l, l, 0x3232);
    hi[0] = prmt(h, h, 0x1010);
    hi[1] = prmt(h, h, 0x3232);
  }
  // bf16((q - 8) * d): the product is exact, so one rounding (the -0 keeps
  // a -0 product's sign)
  __device__ __forceinline__ static uint32_t apply(uint32_t e, uint32_t d) {
    return bf16x2_fma(e, d, 0x80008000u);
  }
};

template <>
struct Scales<float> {
  float lo[2], hi[2];
  __device__ __forceinline__ void load(const uint8_t* lo_row,
                                       const uint8_t* hi_row, int cl) {
    const float2 l = *reinterpret_cast<const float2*>(lo_row + 4 * cl);
    const float2 h = *reinterpret_cast<const float2*>(hi_row + 4 * cl);
    lo[0] = l.x;
    lo[1] = l.y;
    hi[0] = h.x;
    hi[1] = h.y;
  }
  // bf16((q - 8) * d) with the product in f32, rounded once
  __device__ __forceinline__ static uint32_t apply(uint32_t e, float d) {
    const float a = __fmul_rn(__uint_as_float(e << 16), d);
    const float b = __fmul_rn(__uint_as_float(e & 0xFFFF0000u), d);
    const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&p);
  }
};

// A fragments of one k16 step of both planes, a[plane][i]: from the two
// bytes (columns cl, cl + 1) of packed rows 2t, 2t + 1 (r0, r1) and 2t + 8,
// 2t + 9 (r8, r9) of the step. Register i holds column cl + (i & 1) at k
// 2t, 2t + 1 (+ 8 for i >= 2) of the plane, the lower k in its low half.
template <typename ST>
__device__ __forceinline__ void dequant(uint32_t (&a)[2][4], uint32_t r0,
                                        uint32_t r1, uint32_t r8, uint32_t r9,
                                        const Scales<ST>& d) {
  // bytes (row, column): (2t, cl), (2t, cl + 1), (2t + 1, cl), (2t + 1, cl + 1)
  const uint32_t w01 = prmt(r0, r1, 0x5410), w89 = prmt(r8, r9, 0x5410);
  a[0][0] = Scales<ST>::apply(codes(w01), d.lo[0]);
  a[1][0] = Scales<ST>::apply(codes(w01 >> 4), d.hi[0]);
  a[0][1] = Scales<ST>::apply(codes(w01 >> 8), d.lo[1]);
  a[1][1] = Scales<ST>::apply(codes(w01 >> 12), d.hi[1]);
  a[0][2] = Scales<ST>::apply(codes(w89), d.lo[0]);
  a[1][2] = Scales<ST>::apply(codes(w89 >> 4), d.hi[0]);
  a[0][3] = Scales<ST>::apply(codes(w89 >> 8), d.lo[1]);
  a[1][3] = Scales<ST>::apply(codes(w89 >> 12), d.hi[1]);
}

__device__ __forceinline__ uint32_t ld_u16(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// The producer warp: stages st0 .. st0 + count - 1 of K into the ring. By
// TMA where N % 16 == 0 (one thread, the stage's bytes on the barrier's
// transaction count); else the weights and scales by 4-byte cp.async from
// every lane (N % 4 == 0; columns past N zero-filled), each lane's copies
// one arrival, into the same layout. The TMA path reads the weights and scales
// at rows w_row0 and s_row0 on of their maps (a grouped call's expert in a
// stack of them; 0 for one matrix).
template <int T, typename ST>
__device__ __forceinline__ void produce(Ring<T>& rg, const Maps& maps,
                                        const uint8_t* __restrict__ w,
                                        const ST* __restrict__ s, int N,
                                        int G, int m0, int n0, int st0,
                                        int count, bool tma, int w_row0 = 0,
                                        int s_row0 = 0) {
  constexpr int STAGES = Cfg<T>::STAGES;
  constexpr int SV = 4 * (int)sizeof(ST);  // 4 scale columns a copy
  const int lane = threadIdx.x % 32;
  const int g_rows = G == 32 ? 2 : 1;  // group rows of a plane a stage
  const uint32_t bytes =
      2 * T * 128 + (tma ? ROWS * BN + 2 * g_rows * BN * (int)sizeof(ST) : 0);
  for (int it = 0; it < count; ++it) {
    const int slot = it % STAGES;
    if (it >= STAGES) mbar_wait(&rg.empty[slot], (it / STAGES - 1) & 1);
    Slot<T>& sl = rg.slot[slot];
    uint64_t* full = &rg.full[slot];
    const int i = st0 + it, sb = i >> 1, h = i & 1;
    const int k0 = 256 * sb + 64 * h;  // the stage's first low-plane k
    const int prow = 128 * sb + 64 * h;  // its first packed row
    if (lane == 0) {
      mbar_expect_tx(full, bytes);
      tma_load(sl.x[0], &maps.x, full, k0, m0);
      tma_load(sl.x[1], &maps.x, full, k0 + 128, m0);
      if (tma) {
        tma_load(sl.w, &maps.w, full, n0, w_row0 + prow);
        tma_load(sl.sc[0], &maps.s, full, n0, s_row0 + k0 / G);
        tma_load(sl.sc[1], &maps.s, full, n0,
                 s_row0 + (k0 + 128) / G);
      }
    }
    if (tma) continue;
    const uint8_t* wr = w + (size_t)prow * N + n0;
    const uint32_t wd = smem_u32(sl.w);
#pragma unroll 4
    for (int c = lane; c < ROWS * BN / 4; c += 32) {
      const int r = c / (BN / 4), b = 4 * (c % (BN / 4));
      const bool ok = n0 + b < N;
      cp_async<4>(wd + r * BN + (((b >> 4) ^ (r & 7)) << 4) + (b & 15),
                  ok ? wr + (size_t)r * N + b : w, ok ? 4 : 0);
    }
    const bool s_ok = n0 + 4 * lane < N;
    for (int p = 0; p < 2; ++p)
      for (int rr = 0; rr < g_rows; ++rr) {
        const int row = (k0 + 128 * p) / G + rr;
        cp_async<SV>(smem_u32(sl.sc[p]) + rr * BN * (int)sizeof(ST) + SV * lane,
                     s_ok ? s + (size_t)row * N + n0 + 4 * lane : s,
                     s_ok ? SV : 0);
      }
    cp_async_arrive(full);
  }
  __syncwarp();
}

// pins the A fragments' definitions before the next wgmma.fence (else
// ptxas may sink them past it and serialize the products, C7513)
__device__ __forceinline__ void fence_a(uint32_t (&a)[2][4]) {
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[p][i])::"memory");
}

// A consumer warpgroup's share of the block's stages: acc += its 64
// columns' products over the block's K range, one k16 step of both planes
// at a time, double-buffered: the CUDA cores dequantize step j + 1 while
// the tensor cores run step j.
template <int T, typename ST>
__device__ __forceinline__ void consume(Ring<T>& rg, float (&acc)[T / 2],
                                        int G, int count) {
  constexpr int STAGES = Cfg<T>::STAGES;
  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / 128, warp = (tid / 32) % 4, g = lane / 4, t = lane % 4;
  const int cl = 64 * wg + 16 * warp + 2 * g;  // columns cl, cl + 1
  // (packed rows 2t and 2t + 1, column cl) in a stage; rows 16 j + 2t (+ 8)
  // swizzle their chunk by 2t, rows 16 j + 2t + 1 (+ 8) by 2t + 1
  const int we = 2 * t * BN + ((((cl >> 4) ^ (2 * t)) << 4) | (cl & 15));
  const int wo = (2 * t + 1) * BN +
                 ((((cl >> 4) ^ (2 * t + 1)) << 4) | (cl & 15));
  uint32_t a[2][2][4];  // [buffer][plane][register]
  Scales<ST> d;
  for (int it = 0; it < count; ++it) {
    const int slot = it % STAGES;
    mbar_wait(&rg.full[slot], (it / STAGES) & 1);
    const Slot<T>& sl = rg.slot[slot];
    const uint32_t xlo = smem_u32(sl.x[0]), xhi = smem_u32(sl.x[1]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j == 0 || (j == 2 && G == 32)) {
        const int rr = G == 32 ? j / 2 : 0;
        d.load(sl.sc[0] + rr * BN * sizeof(ST), sl.sc[1] + rr * BN * sizeof(ST),
               cl);
      }
      const uint8_t* re = sl.w + we + 16 * j * BN;
      const uint8_t* ro = sl.w + wo + 16 * j * BN;
      dequant<ST>(a[j & 1], ld_u16(re), ld_u16(ro), ld_u16(re + 8 * BN),
                  ld_u16(ro + 8 * BN), d);
      fence_a(a[j & 1]);
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      wgmma_rs<T>(acc, a[j & 1][0], sw128_desc(xlo + 32 * j));
      wgmma_rs<T>(acc, a[j & 1][1], sw128_desc(xhi + 32 * j));
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      wgmma_wait<1>();  // step j - 1 is done: its A fragments are free
      fence_acc(acc);
      // the previous stage's last products are done: its slot goes back
      if (j == 0 && it > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&rg.empty[(it - 1) % STAGES]);
      }
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
}

__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
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


// a 2-D tensor map of rows x cols elements (row stride in bytes) read in
// boxes of box_cols x box_rows; true on success
bool encode_2d(EncodeTiled encode, CUtensorMap* map, CUtensorMapDataType type,
               const void* base, uint64_t cols, uint64_t rows,
               uint64_t stride, uint32_t box_cols, uint32_t box_rows,
               CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {stride};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
