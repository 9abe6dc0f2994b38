// W4A8 matmul on the int8 tensor cores: int8 activations quantized per
// (row, group) at run time, int4 weights, exact int32 group dots.
//
// Replaces: tinychatengine_tpu/ops/int4_matmul.py · int4_matmul_a8
// (body _int4_a8_kernel, pallas_call sites :998 and :1045).
//
//   a_scale = max(absmax(x[m, group]), 1e-8) * f32(1/127)
//   q_a     = clip(rint(x / a_scale), -127, 127)          (f32 division,
//                                                          half to even)
//   dot     = sum_k q_a * (q - 8)                         (exact int32)
//   acc    += (float(dot) * a_scale) * d[g, n]            (two f32 multiplies
//                                                          and an add, groups
//                                                          in K order)
// a_scale is the TPU body's max(absmax, 1e-8) / 127.0 as XLA computes it
// (a division by a constant becomes a multiply by its f32 reciprocal), so
// q_a and a_scale equal the JAX package's bit for bit. The TPU kernel
// computes the same dot as dot(q_a, q) - 8 sum(q_a) on its matrix unit; so
// does this one (u8 codes times s8 activations, then the row's 8 sum(q_a)
// taken off). A call sums its K bands in K order and rounds to bf16 once.
//
// Two launches from one entry point:
// - ``a8_quant_kernel`` (one warp a (row, group)) writes q_a [M, K] int8 in
//   the order the MMA's B fragments read (below) and, per (row, group),
//   a_scale and the integer 0x4B400000 - 8 sum(q_a): added to the raw dot,
//   its bits are the float 1.5 * 2^23 + dot exactly (|dot| < 2^17), so one
//   integer add and one f32 subtract make float(dot) with no convert
//   instruction (the convert pipe runs at a sixteenth of the f32 rate).
// - ``a8_mma_kernel``: y^T = W^T x^T on mma.sync m16n8k32 (u8 x s8 into
//   s32). As in csrc/int4_mma.cuh, weight columns are the m16 operand (a
//   warp owns 32 columns, two m16 tiles) and activation rows the n8
//   operand (8 NT rows a block), so 8 serving rows fill one MMA and a
//   64-row tile reuses every unpacked weight fragment 8 times. A thread
//   (g = lane / 4, t = lane % 4) owns columns 4g..4g+3; tile 0's m16 rows g
//   and g + 8 are columns 4g and 4g + 1, tile 1's 4g + 2 and 4g + 3. An
//   A register holds four codes of one column, which lie in four packed
//   rows: the thread reads the 32-bit words (its four columns) of rows
//   2t + p + 8i (i = 0..3) of the k32 step and transposes each set of four
//   with __byte_perm; the low nibbles are the step's codes of plane 0 (k in
//   the superblock's first 128), the high nibbles plane 1. The int32 dot
//   is exact in any k order, so the step's logical k 4t + i holds physical
//   k 2t + 8i and logical 16 + 4t + i physical 2t + 1 + 8i; the quantizer
//   writes q_a in that order, so a B fragment is ldmatrix of 16 stored
//   bytes. With a row stride of 144 bytes the four rows 2t + p + 8i of one
//   load fall in 32 distinct banks. Each group's k32 steps accumulate into
//   a fresh s32 fragment, folded at the group's end as above (no fma).
//   Data movement: a two-stage cp.async ring of superblocks, each the
//   packed [128, 128] slab, the block's q_a rows [MT, 256], their a_scale
//   and offsets, and the scale rows, coalesced along N as stored; rows past
//   M and columns past N are zero-filled. The kernel is launched with
//   programmatic dependent launch: a block requests its first weights and
//   scales while the quantize kernel still runs, then waits for it
//   (griddepcontrol.wait) before it requests q_a.
// K is split over blockIdx.z in bands of whole superblocks (the wrapper's
// ``a8_split``: from K and N alone). The bands of one column and row tile
// form one thread-block cluster (at most 8): each block leaves its f32
// sums in its shared memory and, after a cluster barrier, each block adds a
// share of the tile over the cluster's blocks in K order (distributed
// shared memory) and rounds to bf16: no scratch in device memory and no
// third launch.
//
// Bound on the H100: bytes at M <= 100: the N * K / 2 weight bytes over
// 3.35 TB/s (gate_up: 58.7 MB, 0.018 ms); the int8 products (15 GOP at 64
// rows, 0.008 ms at the 1979 TOP/s peak) and the per-group folds on the
// f32 pipe (64 x 28672 x 32 folds, five instructions each, about 0.01 ms)
// sit under it. In practice a 64-row tile holds 255 registers, two blocks
// an SM, and its folds and unpack at 8 warps an SM keep gate_up M = 64 at
// about 2.4x the byte bound (PERF.md); the CUDA-core kernel this replaced
// (one __dp4a plus a convert and three f32 operations per 4 k, 8-row
// tiles) took 0.81 ms there.
//
// Determinism: a row's bits depend on its own x row, K, N and the band
// split, never on M or on its row tile (rows never mix in an MMA; the k
// order, the fold order and the band order are fixed).

#include <cooperative_groups.h>

#include <algorithm>

#include "int4_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using tce::mma4::cp_async16;
using tce::mma4::cp_async_commit;
using tce::mma4::cp_async_wait;
using tce::mma4::load_scales;
using tce::mma4::smem_u32;

constexpr int SB = 256;     // K rows per superblock
constexpr int PLANE = 128;  // packed rows per superblock
constexpr int BN = 128;         // columns per block
constexpr int MAX_BANDS = 8;    // the portable cluster size
constexpr int QUANT_THREADS = 256;
constexpr int FLOAT_BIAS = 0x4B400000;  // the bits of 1.5 * 2^23
constexpr float FLOAT_BIAS_F = 12582912.0f;
// the TPU body's / 127.0 as XLA runs it: a multiply by the f32 reciprocal
// (its simplifier rewrites a division by a constant)
constexpr float RECIP_127 = 1.0f / 127.0f;

// position of k (0..31 within a k32 step) in the stored q_a order
__device__ __forceinline__ int stored_pos(int j) {
  return 16 * (j & 1) + 4 * ((j & 7) >> 1) + (j >> 3);
}

__global__ void __launch_bounds__(QUANT_THREADS) a8_quant_kernel(
    const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ qa,
    int2* __restrict__ aux, int M, int K, int G) {
  // the contraction kernel may start now: it requests its first weights,
  // then waits for this grid (griddepcontrol.wait)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int lane = threadIdx.x % 32;
  const int ng = K / G;
  const int total = M * ng;
  const int per_lane = G / 32;  // 1, 2 or 4
  for (int wi = blockIdx.x * (QUANT_THREADS / 32) + threadIdx.x / 32;
       wi < total; wi += gridDim.x * (QUANT_THREADS / 32)) {
    const int m = wi / ng, g = wi % ng;
    const __nv_bfloat16* row = x + (size_t)m * K + (size_t)g * G;
    float v[4];
    float amax = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (t < per_lane) {
        v[t] = __bfloat162float(row[lane + 32 * t]);
        amax = fmaxf(amax, fabsf(v[t]));
      }
    }
    amax = tce::warp_max(amax);
    const float sc = __fmul_rn(fmaxf(amax, 1e-8f), RECIP_127);
    int qsum = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (t < per_lane) {
        const int q =
            (int)fminf(fmaxf(rintf(__fdiv_rn(v[t], sc)), -127.f), 127.f);
        qsum += q;
        const int k = g * G + lane + 32 * t;  // lane + 32 t: the step's j
        qa[(size_t)m * K + (k & ~31) + stored_pos(lane)] = (int8_t)q;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      qsum += __shfl_xor_sync(0xffffffffu, qsum, o);
    if (lane == 0)
      aux[(size_t)m * ng + g] =
          make_int2(__float_as_int(sc), FLOAT_BIAS - 8 * qsum);
  }
}

// four warps side by side, each 32 columns by the block's 8 NT rows; a
// two-stage ring (three stages ran slower at 1 and 8 rows: fewer blocks an
// SM), each stage [weights 128 x WS][q_a MT x QS][aux MT x SB/G int2]
// [scales SB/G x BN]
template <typename ST, int G, int NT_>
struct Cfg {
  static constexpr int NT = NT_;
  static constexpr int THREADS = 128;
  static constexpr int STAGES = 2;
  static constexpr int MT = 8 * NT;       // rows per block
  static constexpr int WS = BN + 16;      // bytes per staged packed row
  static constexpr int QS = SB + 16;      // bytes per staged q_a row
  static constexpr int GPS = SB / G;      // groups per superblock
  static constexpr int Q_OFF = PLANE * WS;
  static constexpr int A_OFF = Q_OFF + MT * QS;
  static constexpr int S_OFF = A_OFF + MT * GPS * 8;
  static constexpr int STAGE = S_OFF + GPS * BN * (int)sizeof(ST);
  static constexpr int SMEM = STAGES * STAGE;
  static_assert(MT * BN * 4 <= SMEM, "the band sums fit in the ring");
};

// superblock sb's weight slab and scale rows into one ring stage (they do
// not depend on the quantize kernel)
template <typename ST, int G, class C>
__device__ __forceinline__ void load_weights(uint8_t* st,
                                             const uint8_t* __restrict__ w,
                                             const ST* __restrict__ s, int N,
                                             int n0, int sb) {
  const int tid = threadIdx.x;
  constexpr int WCH = BN / 16;  // 16-byte chunks of a packed row
#pragma unroll
  for (int j = 0; j < PLANE * WCH / C::THREADS; ++j) {
    const int i = tid + j * C::THREADS;
    const int r = i / WCH, c = i % WCH;
    const bool in = n0 + c * 16 < N;
    cp_async16(smem_u32(st + r * C::WS + c * 16),
               w + (size_t)(sb * PLANE + r) * N + (in ? n0 + c * 16 : 0), in);
  }
  constexpr int PER = 16 / sizeof(ST);  // scale columns per chunk
  constexpr int SCH = BN / PER;
  constexpr int SN = C::GPS * SCH;
#pragma unroll
  for (int j = 0; j < (SN + C::THREADS - 1) / C::THREADS; ++j) {
    const int i = tid + j * C::THREADS;
    const int r = i / SCH, c = i % SCH;
    const bool in = n0 + c * PER < N;
    if (i < SN)
      cp_async16(smem_u32(st + C::S_OFF + (r * BN + c * PER) * sizeof(ST)),
                 s + (size_t)(sb * C::GPS + r) * N + (in ? n0 + c * PER : 0),
                 in);
  }
}

// superblock sb's q_a rows and their (a_scale, offset) pairs into one ring
// stage (written by the quantize kernel)
template <int G, class C>
__device__ __forceinline__ void load_acts(uint8_t* st,
                                          const int8_t* __restrict__ qa,
                                          const int2* __restrict__ aux, int M,
                                          int K, int m0, int sb) {
  const int tid = threadIdx.x;
  constexpr int QCH = SB / 16;  // 16-byte chunks of a q_a row
#pragma unroll
  for (int j = 0; j < C::MT * QCH / C::THREADS; ++j) {
    const int i = tid + j * C::THREADS;
    const int r = i / QCH, c = i % QCH;
    const bool in = m0 + r < M;
    cp_async16(smem_u32(st + C::Q_OFF + r * C::QS + c * 16),
               qa + (size_t)(in ? m0 + r : 0) * K + sb * SB + c * 16, in);
  }
  constexpr int ACH = C::GPS / 2;  // 16-byte chunks of a row's aux
  const int ng = K / G;
#pragma unroll
  for (int j = 0; j < (C::MT * ACH + C::THREADS - 1) / C::THREADS; ++j) {
    const int i = tid + j * C::THREADS;
    const int r = i / ACH, c = i % ACH;
    const bool in = m0 + r < M;
    if (i < C::MT * ACH)
      cp_async16(smem_u32(st + C::A_OFF + r * C::GPS * 8 + c * 16),
                 aux + (size_t)(in ? m0 + r : 0) * ng + sb * C::GPS + 2 * c,
                 in);
  }
}

// d += a (16 x 32, row, u8) . b (32 x 8, col, s8), s32 accumulate
__device__ __forceinline__ void mma_u8s8(int (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}

// four words (rows) of four bytes (columns) -> four words of one column
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4],
                                           uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

// acc += (float(dot) * a_scale) * d for the group gi of a staged
// superblock: C element e of (tile, nt) is column 4g + 2 tile + e / 2 of
// the warp's and row nt * 8 + 2t + e % 2
template <typename ST, int G, class C, int NT = C::NT>
__device__ __forceinline__ void fold(float (&acc)[2][NT][4],
                                     const int (&dot)[2][NT][4],
                                     const uint8_t* st, int warp, int lane,
                                     int gi) {
  const int g = lane / 4, t = lane % 4;
  float d[4];
  load_scales(reinterpret_cast<const ST*>(st + C::S_OFF) + gi * BN +
                  warp * 32 + 4 * g,
              d);
  const int2* ax = reinterpret_cast<const int2*>(st + C::A_OFF);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    int2 a[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) a[e] = ax[(nt * 8 + 2 * t + e) * C::GPS + gi];
#pragma unroll
    for (int tile = 0; tile < 2; ++tile)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int2 r = a[e & 1];
        const float f =
            __fsub_rn(__int_as_float(dot[tile][nt][e] + r.y), FLOAT_BIAS_F);
        acc[tile][nt][e] =
            __fadd_rn(acc[tile][nt][e],
                      __fmul_rn(__fmul_rn(f, __int_as_float(r.x)),
                                d[2 * tile + (e >> 1)]));
      }
  }
}

// one staged superblock into the warp's sums
template <typename ST, int G, class C, int NT = C::NT>
__device__ __forceinline__ void compute_stage(const uint8_t* st,
                                              float (&acc)[2][NT][4],
                                              int warp) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const uint8_t* wcol = st + warp * 32 + 4 * g + 2 * t * C::WS;
  // ldmatrix: lane l gives row (l & 7) of matrix l >> 3: rows of n8 tile
  // nt + (l >> 4), bytes 16 ((l >> 3) & 1) on of the k32 step
  const uint32_t qb = smem_u32(st + C::Q_OFF) +
                      ((lane & 7) + 8 * (lane >> 4)) * C::QS +
                      16 * ((lane >> 3) & 1);
  int dot[2][NT][4];
#pragma unroll
  for (int plane = 0; plane < 2; ++plane) {
#pragma unroll
    for (int step = 0; step < PLANE / 32; ++step) {
      const int r0 = 32 * step;
      if ((r0 & (G - 1)) == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) dot[i][nt][e] = 0;
      }
      uint32_t rw[2][4], cw[2][4];
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          rw[p][i] = *reinterpret_cast<const uint32_t*>(
              wcol + (r0 + p + 8 * i) * C::WS);
      transpose4(rw[0], cw[0]);
      transpose4(rw[1], cw[1]);
      const int sh = 4 * plane;
      uint32_t a[2][4];
#pragma unroll
      for (int tile = 0; tile < 2; ++tile) {
        a[tile][0] = (cw[0][2 * tile] >> sh) & 0x0F0F0F0Fu;
        a[tile][1] = (cw[0][2 * tile + 1] >> sh) & 0x0F0F0F0Fu;
        a[tile][2] = (cw[1][2 * tile] >> sh) & 0x0F0F0F0Fu;
        a[tile][3] = (cw[1][2 * tile + 1] >> sh) & 0x0F0F0F0Fu;
      }
      const int kk = plane * PLANE + r0;  // the step's first stored byte
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t b[4];
        if constexpr (NT == 1) {
          uint32_t b2[2];
          ldmatrix_x2(b2, qb + kk);
          b[0] = b2[0], b[1] = b2[1];
        } else {
          tce::mma4::ldmatrix_x4(b, qb + nt * 8 * C::QS + kk);
        }
#pragma unroll
        for (int tile = 0; tile < 2; ++tile) {
          mma_u8s8(dot[tile][nt], a[tile], b[0], b[1]);
          if constexpr (NT > 1) mma_u8s8(dot[tile][nt + 1], a[tile], b[2], b[3]);
        }
      }
      if (((r0 + 32) & (G - 1)) == 0)  // the group ends: fold it in
        fold<ST, G, C>(acc, dot, st, warp, lane, (plane * PLANE + r0) / G);
    }
  }
}

__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* p, float a,
                                             float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 v;
  v.x = *reinterpret_cast<const uint32_t*>(&lo);
  v.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}

// one (128 columns, MT rows, band) item of a [N/128, M/MT, bands] grid,
// the bands of a tile one cluster
template <typename ST, int G, int NT>
__global__ void __launch_bounds__(128) a8_mma_kernel(
    const int8_t* __restrict__ qa, const int2* __restrict__ aux,
    const uint8_t* __restrict__ w, const ST* __restrict__ s,
    __nv_bfloat16* __restrict__ y, int M, int K, int N, int sb_per_band) {
  using C = Cfg<ST, G, NT>;
  constexpr int STAGES = C::STAGES;
  constexpr int THREADS = C::THREADS;
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * C::MT;
  const int bands = gridDim.z;
  const int sb0 = blockIdx.z * sb_per_band;
  const int count = min(sb_per_band, K / SB - sb0);

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;

  // the first weights are requested before the quantize kernel has ended
  // (programmatic dependent launch): q_a and aux only after it
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i)
    if (i < count)
      load_weights<ST, G, C>(smem + i * C::STAGE, w, s, N, n0, sb0 + i);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < count)
      load_acts<G, C>(smem + i * C::STAGE, qa, aux, M, K, m0, sb0 + i);
    cp_async_commit();
  }
  for (int i = 0; i < count; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage i landed; stage i - 1 is free again
    const int nx = i + STAGES - 1;
    if (nx < count) {
      uint8_t* st = smem + (nx % STAGES) * C::STAGE;
      load_weights<ST, G, C>(st, w, s, N, n0, sb0 + nx);
      load_acts<G, C>(st, qa, aux, M, K, m0, sb0 + nx);
    }
    cp_async_commit();
    compute_stage<ST, G, C>(smem + (i % STAGES) * C::STAGE, acc, warp);
  }
  cp_async_wait<0>();

  // thread (g, t) holds rows nt * 8 + 2t + e, columns 4g .. 4g + 3 of the
  // warp's
  const int g = lane / 4, t = lane % 4;
  const int col = warp * 32 + 4 * g;
  if (bands == 1) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + nt * 8 + 2 * t + e;
        if (m < M && n0 + col < N)
          store_bf16x4(y + (size_t)m * N + n0 + col, acc[0][nt][e],
                       acc[0][nt][2 + e], acc[1][nt][e], acc[1][nt][2 + e]);
      }
    return;
  }
  __syncthreads();  // every warp is done with the ring
  float* red = reinterpret_cast<float*>(smem);  // [MT][BN]
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<float4*>(red + (nt * 8 + 2 * t + e) * BN + col) =
          make_float4(acc[0][nt][e], acc[0][nt][2 + e], acc[1][nt][e],
                      acc[1][nt][2 + e]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every band's sums are in its shared memory
  // block z of the cluster sums every bands-th float4 of the tile over the
  // bands in K order
  const int rank = (int)cluster.block_rank();
  for (int i = rank * THREADS + threadIdx.x; i < C::MT * BN / 4;
       i += bands * THREADS) {
    const int r = i / (BN / 4), c = 4 * (i % (BN / 4));
    const int m = m0 + r;
    if (m >= M || n0 + c >= N) continue;
    float4 v = *reinterpret_cast<const float4*>(
        cluster.map_shared_rank(red, 0) + r * BN + c);
    for (int z = 1; z < bands; ++z) {
      const float4 u = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(red, z) + r * BN + c);
      v.x = __fadd_rn(v.x, u.x);
      v.y = __fadd_rn(v.y, u.y);
      v.z = __fadd_rn(v.z, u.z);
      v.w = __fadd_rn(v.w, u.w);
    }
    store_bf16x4(y + (size_t)m * N + n0 + c, v.x, v.y, v.z, v.w);
  }
  cluster.sync();  // no block leaves while another reads its sums
}

template <typename ST, int G, int NT>
int launch_cfg(const void* qa, const void* aux, const void* w, const void* s,
               void* y, int M, int K, int N, int sb_per_band, int bands,
               cudaStream_t st) {
  using C = Cfg<ST, G, NT>;
  auto kernel = a8_mma_kernel<ST, G, NT>;
  static bool configured = false;  // once, outside any CUDA graph capture
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, (M + C::MT - 1) / C::MT, bands);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = 1;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = bands;
  cfg.attrs = attr;
  cfg.numAttrs = bands > 1 ? 2 : 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const int8_t*>(qa),
      static_cast<const int2*>(aux), static_cast<const uint8_t*>(w),
      static_cast<const ST*>(s), static_cast<__nv_bfloat16*>(y), M, K, N,
      sb_per_band);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <typename ST, int G>
int launch_g(const void* qa, const void* aux, const void* w, const void* s,
             void* y, int M, int K, int N, int sb_per_band, int bands,
             cudaStream_t st) {
  switch (tce::mma4::row_tile(M)) {
    case 8:
      return launch_cfg<ST, G, 1>(qa, aux, w, s, y, M, K, N, sb_per_band,
                                  bands, st);
    case 16:
      return launch_cfg<ST, G, 2>(qa, aux, w, s, y, M, K, N, sb_per_band,
                                  bands, st);
    case 32:
      return launch_cfg<ST, G, 4>(qa, aux, w, s, y, M, K, N, sb_per_band,
                                  bands, st);
    default:
      return launch_cfg<ST, G, 8>(qa, aux, w, s, y, M, K, N, sb_per_band,
                                  bands, st);
  }
}

template <typename ST>
int launch_main(const void* qa, const void* aux, const void* w, const void* s,
                void* y, int M, int K, int N, int G, int sb_per_band,
                int bands, cudaStream_t st) {
  switch (G) {
    case 32:
      return launch_g<ST, 32>(qa, aux, w, s, y, M, K, N, sb_per_band, bands,
                              st);
    case 64:
      return launch_g<ST, 64>(qa, aux, w, s, y, M, K, N, sb_per_band, bands,
                              st);
    default:
      return launch_g<ST, 128>(qa, aux, w, s, y, M, K, N, sb_per_band, bands,
                               st);
  }
}

}  // namespace

// x [M, K] bf16 (K already padded to the packed K); w [K/2, N] uint8; s
// [K/G, N] (bf16 when scale_bf16 != 0, else f32), w and s 16-byte aligned;
// scratch: qa [M, K] int8, aux [M, K/G] int2; y [M, N] bf16. K splits into
// bands of sb_per_band superblocks, 1 to 8 bands (one cluster). Needs K %
// 256 == 0, N % 16 == 0, G in {32, 64, 128}.
extern "C" int tce_int4_matmul_a8(const void* x, const void* w, const void* s,
                                  int scale_bf16, void* qa, void* aux, void* y,
                                  int M, int K, int N, int G, int sb_per_band,
                                  int bands, void* stream) {
  if (bands < 1 || bands > MAX_BANDS || (bands - 1) * sb_per_band >= K / SB)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int groups = M * (K / G);
  const int qblocks = std::min(
      (groups + QUANT_THREADS / 32 - 1) / (QUANT_THREADS / 32), 4096);
  a8_quant_kernel<<<qblocks, QUANT_THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(qa),
      static_cast<int2*>(aux), M, K, G);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return scale_bf16 ? launch_main<__nv_bfloat16>(qa, aux, w, s, y, M, K, N, G,
                                                 sb_per_band, bands, st)
                    : launch_main<float>(qa, aux, w, s, y, M, K, N, G,
                                         sb_per_band, bands, st);
}
