// INT3 fused dequant matmul (the W3 experiment): y[M, N] = x[M, K] @
// ((A + 4 B - 4) * d), on the tensor cores.
//
// Replaces: tinychatengine_tpu/ops/int3_matmul.py · int3_matmul (body
// _int3_kernel, pallas_call site :154).
//
// Layout QM_TPU3, read as stored: plane A (low 2 bits) [K/4, N], four K rows
// a byte: in A-superblock s (512 K rows), byte row i bits [2j, 2j+1] hold
// k = 512 s + 128 j + i; plane B (high bit) [K/8, N], eight a byte: in
// B-superblock t (1024 K rows), byte row i bit j holds k = 1024 t + 128 j + i.
// Scales [K/G, N] f32.
//
// Arithmetic: the TPU kernel keeps the zero point and the B plane out of
// the per-element path, (x . A + 4 x . B - 4 sum x) * d per group on its
// matrix unit. Here the codes enter as bf16 A + 4B - 4 (exact: -4..3):
// the three code bits are put into the low mantissa bits of bf16 128
// (0x4300) by two lop3, then bf16 132 is subtracted. Each group's k16 steps
// accumulate x . (q - 4) into a fresh f32 fragment with mma.sync m16n8k16
// (bf16 in, f32 accumulate), and at the group's end
//   acc = fma(dot, d, acc)
// folds it in, groups in K order: the same function summed in another
// order, as csrc/int4_mma.cuh's contraction differs from the int4 TPU
// kernels. Orientation, fragments and fold are int4_mma.cuh's: weight
// columns are the m16 operand (a warp owns 32, two m16 tiles), activation
// rows the n8 operand (a block 8, 16, 32 or 64 rows: ``row_tile``; at 64
// rows eight warps, two warp rows of 32). A k16 step at a fixed j needs
// byte rows 2t, 2t + 1, 2t + 8 and 2t + 9 of the 128-row run, which both
// planes hold, with the k's code in bits 2j' of A (j' = j mod 4) and in
// bit j of B: a thread reads the four 32-bit words (its four columns) of
// each plane, merges each row's two words into 3-bit codes (a shift, a
// rotate and one lop3), then pairs rows with a byte permute and makes bf16
// pairs as the int4 unpack does.
//
// Data movement: the two planes' periods differ (A 512 K rows, B 1024), so
// a ring stage is one A-superblock (512 K rows): its A slab [128, 128]
// bytes (rows padded to 144 bytes: conflict-free fragment loads), the
// block's x rows [MT, 512] bf16 (rows padded to 1040 bytes for ldmatrix)
// and its 512 / G scale rows, by 16-byte cp.async, coalesced along N; the
// B slab [128, 128] of the B-superblock is requested with the chunk's first
// half into one of two B buffers and read by both halves. Two stages and
// two B buffers take 94-107 KB at 8 rows (two blocks an SM) and 211-223 KB
// at 64 rows (one block an SM), so every row tile keeps a two-stage ring
// (the x of a 64-row tile is 65 KB a stage). Stage i + 1 is requested as
// stage i is multiplied. K splits over blockIdx.z into bands of whole
// 1024-row chunks (the wrapper's ``int3_split``: from K and N alone up to
// 8 rows), each writing f32 sums to a [bands, M, N] scratch;
// ``reduce_bands`` adds the bands in K order and rounds to bf16 once.
//
// Bound on the H100: bytes at small M, 3/8 byte a weight plus the f32
// scales over 3.35 TB/s (gate_up K 4096, N 28672: 47.7 MB, 0.0143 ms). The
// CUDA-core kernel this replaced took two f32 FMAs per code and row (x . A
// and x . B) and re-read the weights once per 8 rows.
//
// Determinism: a row's bits depend on its own x row, K, N and the band
// split, never on M or its row tile.

#include "int4_band.cuh"
#include "int4_mma.cuh"

namespace {

using tce::mma4::cp_async16;
using tce::mma4::cp_async_commit;
using tce::mma4::cp_async_wait;
using tce::mma4::smem_u32;

constexpr int CHUNK = 1024;  // K rows of one B-superblock
constexpr int HALF = 512;    // K rows of one A-superblock: one ring stage
constexpr int PLANE = 128;   // byte rows of either plane's superblock

// four warps side by side, each 32 columns, by WR warp rows of NTW n8
// tiles (two warp rows of 32 rows at 64 rows: the block's 211-223 KB of
// shared memory leave one block an SM, and a warp of 64 rows holds too
// many sums to stay in registers); a ring of two stages [x][A slab]
// [scales], then two B slabs. Past 16 rows the x loader is left rolled
// (its copy addresses would otherwise stay live).
template <int G, int NT>
struct Cfg {
  static constexpr bool ROLL_X = NT >= 4;
  static constexpr int WR = NT == 8 ? 2 : 1;  // warp rows
  static constexpr int NTW = NT / WR;         // n8 tiles a warp
  static constexpr int THREADS = 128 * WR;
  static constexpr int BN = 128;         // columns per block
  static constexpr int MT = 8 * NT;      // rows per block
  static constexpr int WS = BN + 16;     // bytes per staged byte row
  static constexpr int XS = HALF + 8;    // bf16 per staged x row
  static constexpr int A_OFF = MT * XS * 2;
  static constexpr int S_OFF = A_OFF + PLANE * WS;
  static constexpr int STAGE = S_OFF + (HALF / G) * BN * 4;
  static constexpr int B_OFF = 2 * STAGE;
  static constexpr int SMEM = B_OFF + 2 * PLANE * WS;
};

// byte rows [row0, row0 + 128) of a plane, columns n0.., into a slab
template <class C>
__device__ __forceinline__ void load_slab(uint8_t* slab,
                                          const uint8_t* __restrict__ p,
                                          int N, int n0, int row0) {
  constexpr int WCH = C::BN / 16;  // 16-byte chunks of a byte row
#pragma unroll
  for (int j = 0; j < PLANE * WCH / C::THREADS; ++j) {
    const int i = threadIdx.x + j * C::THREADS;
    const int r = i / WCH, c = i % WCH;
    const bool in = n0 + c * 16 < N;
    cp_async16(smem_u32(slab + r * C::WS + c * 16),
               p + (size_t)(row0 + r) * N + (in ? n0 + c * 16 : 0), in);
  }
}

// A-superblock h (K rows 512 h..): its A slab, scale rows and the block's
// x rows into one ring stage
template <int G, class C>
__device__ __forceinline__ void load_stage(uint8_t* st,
                                           const __nv_bfloat16* __restrict__ x,
                                           const uint8_t* __restrict__ pa,
                                           const float* __restrict__ s, int M,
                                           int K, int N, int m0, int n0,
                                           int h) {
  const int tid = threadIdx.x;
  load_slab<C>(st + C::A_OFF, pa, N, n0, h * PLANE);
  constexpr int SCH = C::BN / 4;  // 16-byte chunks of a scale row
  constexpr int SN = HALF / G * SCH;
#pragma unroll
  for (int j = 0; j < (SN + C::THREADS - 1) / C::THREADS; ++j) {
    const int i = tid + j * C::THREADS;
    const int r = i / SCH, c = i % SCH;
    const bool in = n0 + c * 4 < N;
    if (i < SN)
      cp_async16(smem_u32(st + C::S_OFF + (r * C::BN + c * 4) * 4),
                 s + (size_t)(h * (HALF / G) + r) * N + (in ? n0 + c * 4 : 0),
                 in);
  }
  constexpr int XCH = HALF / 8;  // 16-byte chunks of a staged x row
  static_assert(C::MT * XCH % C::THREADS == 0, "whole x chunks");
  auto x_chunk = [&](int j) {
    const int i = tid + j * C::THREADS;
    const int r = i / XCH, c = i % XCH;
    const bool in = m0 + r < M;
    cp_async16(smem_u32(st + (r * C::XS + c * 8) * 2),
               x + (size_t)(in ? m0 + r : 0) * K + h * HALF + c * 8, in);
  };
  if constexpr (C::ROLL_X) {
#pragma unroll 1
    for (int j = 0; j < C::MT * XCH / C::THREADS; ++j) x_chunk(j);
  } else {
#pragma unroll
    for (int j = 0; j < C::MT * XCH / C::THREADS; ++j) x_chunk(j);
  }
}

// the codes of the four columns of one byte row in run JA, A's bits 2 JA
// and 2 JA + 1 and B's bit J, as A + 4B in bits 0-2 of each byte (bits 3-7
// hold left-over bits): A shifted down, B rotated right by J - 2 (mod 32,
// so bit J of each byte lands on its bit 2), one lop3 taking bits 0-1 of
// each byte from A and the rest from B
template <int JA, int J>
__device__ __forceinline__ uint32_t codes3(uint32_t wa, uint32_t wb) {
  uint32_t v;
  asm("lop3.b32 %0, %1, %2, %3, 0xe4;"  // (a & c) | (b & ~c)
      : "=r"(v)
      : "r"(wa >> (2 * JA)), "r"(__funnelshift_r(wb, wb, (J + 30) & 31)),
        "r"(0x03030303u));
  return v;
}

// the codes at bits 0-2 and 16-18 of u as a bf16 pair q - 4, exactly:
// (u & 0x00070007) | 0x43004300 in one lop3 is bf16 128 + q, minus bf16 132
__device__ __forceinline__ uint32_t codes_q4(uint32_t u) {
  uint32_t v;
  asm("lop3.b32 %0, %1, %2, %3, 0xea;"  // (a & b) | c
      : "=r"(v)
      : "r"(u), "r"(0x00070007u), "r"(0x43004300u));
  const uint32_t c = 0x43044304u;
  __nv_bfloat162 h = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                             *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<uint32_t*>(&h);
}

// the A fragments of the k16 step at byte row r0 of run JA (B bit J) for
// the warp's two m16 tiles: the four rows' codes as in ``codes3``, then
// int4_mma.cuh's weight_frags on them (rows paired by a byte permute)
template <class C, int JA, int J>
__device__ __forceinline__ void weight_frags(const uint8_t* acol,
                                             const uint8_t* bcol, int r0,
                                             int t, uint32_t (&a)[2][4]) {
  const int off = (r0 + 2 * t) * C::WS;
  uint32_t c[4];  // rows 2t, 2t + 1, 2t + 8, 2t + 9
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = off + ((i & 1) + 8 * (i >> 1)) * C::WS;
    c[i] = codes3<JA, J>(*reinterpret_cast<const uint32_t*>(acol + row),
                         *reinterpret_cast<const uint32_t*>(bcol + row));
  }
#pragma unroll
  for (int tile = 0; tile < 2; ++tile) {
    const uint32_t sel = tile ? 0x7632u : 0x5410u;
    const uint32_t u = __byte_perm(c[0], c[1], sel);
    const uint32_t v = __byte_perm(c[2], c[3], sel);
    a[tile][0] = codes_q4(u);
    a[tile][1] = codes_q4(u >> 8);
    a[tile][2] = codes_q4(v);
    a[tile][3] = codes_q4(v >> 8);
  }
}

// run JA of one staged A-superblock (H: the chunk's half, so run JA is B's
// bit 4 H + JA) into the warp's sums over its NT n8 tiles, groups in K
// order
template <int G, class C, int NT, int H, int JA>
__device__ __forceinline__ void compute_run(const uint8_t* acol,
                                            const uint8_t* bcol,
                                            const float* ss, uint32_t xb,
                                            float (&acc)[2][NT][4], int t) {
  float dot[2][NT][4];
#pragma unroll
  for (int sp = 0; sp < PLANE / 32; ++sp) {
    uint32_t b[NT][4];  // B fragments of k16 steps 2 sp and 2 sp + 1
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      tce::mma4::ldmatrix_x4(
          b[nt], xb + (nt * 8 * C::XS + JA * PLANE + 32 * sp) * 2);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r0 = 32 * sp + 16 * hh;
      if ((r0 & (G - 1)) == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) dot[i][nt][e] = 0.f;
      }
      uint32_t a[2][4];
      weight_frags<C, JA, 4 * H + JA>(acol, bcol, r0, t, a);
#pragma unroll
      for (int tile = 0; tile < 2; ++tile)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          tce::mma4::mma_bf16(dot[tile][nt], a[tile], b[nt][2 * hh],
                              b[nt][2 * hh + 1]);
      if (((r0 + 16) & (G - 1)) == 0)  // the group ends: fold it in
        tce::mma4::fold<float, G, C, NT>(acc, dot, ss, JA, r0);
    }
  }
}

// one staged A-superblock into the warp's sums: columns 32 (warp % 4)..
// of the block's 128, n8 tiles NT (warp / 4)..
template <int G, class C, int NT, int H>
__device__ __forceinline__ void compute_stage(const uint8_t* st,
                                              const uint8_t* bslab,
                                              float (&acc)[2][NT][4],
                                              int warp) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int col = (warp % 4) * 32 + 4 * g;
  const uint8_t* acol = st + C::A_OFF + col;
  const uint8_t* bcol = bslab + col;
  const float* ss = reinterpret_cast<const float*>(st + C::S_OFF) + col;
  const uint32_t xb =
      smem_u32(st) +
      (((warp / 4) * NT * 8 + (lane & 7)) * C::XS + 8 * (lane >> 3)) * 2;
  compute_run<G, C, NT, H, 0>(acol, bcol, ss, xb, acc, t);
  compute_run<G, C, NT, H, 1>(acol, bcol, ss, xb, acc, t);
  compute_run<G, C, NT, H, 2>(acol, bcol, ss, xb, acc, t);
  compute_run<G, C, NT, H, 3>(acol, bcol, ss, xb, acc, t);
}

// one (128 columns, MT rows, band) item of a [N/128, M/MT, bands] grid: the
// band's sums into part[band]
template <int G, int NT>
__global__ void __launch_bounds__(Cfg<G, NT>::THREADS)
    int3_mma_kernel(const __nv_bfloat16* __restrict__ x,
                    const uint8_t* __restrict__ pa,
                    const uint8_t* __restrict__ pb,
                    const float* __restrict__ s, float* __restrict__ part,
                    int M, int K, int N, int chunks_per_band) {
  using C = Cfg<G, NT>;
  constexpr int NTW = C::NTW;
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.z * chunks_per_band;
  const int count = 2 * min(chunks_per_band, K / CHUNK - c0);  // stages
  const int h0 = 2 * c0;
  const int m0 = blockIdx.y * C::MT, n0 = blockIdx.x * C::BN;
  uint8_t* bslabs = smem + C::B_OFF;

  float acc[2][NTW][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;

  load_stage<G, C>(smem, x, pa, s, M, K, N, m0, n0, h0);
  load_slab<C>(bslabs, pb, N, n0, c0 * PLANE);
  cp_async_commit();
  for (int i = 0; i < count; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // stage i landed; stage i - 1 and its chunk's B free
    if (i + 1 < count) {
      load_stage<G, C>(smem + ((i + 1) % 2) * C::STAGE, x, pa, s, M, K, N,
                       m0, n0, h0 + i + 1);
      if (i % 2)  // stage i + 1 opens a chunk: its B slab too
        load_slab<C>(bslabs + ((i + 1) / 2 % 2) * PLANE * C::WS, pb, N, n0,
                     (c0 + (i + 1) / 2) * PLANE);
    }
    cp_async_commit();
    const uint8_t* st = smem + (i % 2) * C::STAGE;
    const uint8_t* bslab = bslabs + (i / 2 % 2) * PLANE * C::WS;
    if (i % 2)
      compute_stage<G, C, NTW, 1>(st, bslab, acc, warp);
    else
      compute_stage<G, C, NTW, 0>(st, bslab, acc, warp);
  }
  cp_async_wait<0>();

  // row 2t + e of n8 tile nt: columns 4g .. 4g + 3 as one 16-byte store
  const int g = lane / 4, t = lane % 4;
  const int n = n0 + (warp % 4) * 32 + 4 * g;
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + ((warp / 4) * NTW + nt) * 8 + 2 * t + e;
      if (m < M && n < N)
        *reinterpret_cast<float4*>(part + ((size_t)blockIdx.z * M + m) * N +
                                   n) =
            make_float4(acc[0][nt][e], acc[0][nt][2 + e], acc[1][nt][e],
                        acc[1][nt][2 + e]);
    }
}

template <int G, int NT>
int launch_cfg(const void* x, const void* pa, const void* pb, const void* s,
               float* part, int M, int K, int N, int chunks_per_band,
               int bands, cudaStream_t st) {
  using C = Cfg<G, NT>;
  auto kernel = int3_mma_kernel<G, NT>;
  static bool configured = false;  // once, outside any CUDA graph capture
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((N + C::BN - 1) / C::BN, (M + C::MT - 1) / C::MT, bands);
  kernel<<<grid, C::THREADS, C::SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(pa),
      static_cast<const uint8_t*>(pb), static_cast<const float*>(s), part, M,
      K, N, chunks_per_band);
  return (int)cudaGetLastError();
}

template <int G>
int launch_g(const void* x, const void* pa, const void* pb, const void* s,
             float* part, int M, int K, int N, int chunks_per_band, int bands,
             cudaStream_t st) {
  switch (tce::mma4::row_tile(M)) {
    case 8:
      return launch_cfg<G, 1>(x, pa, pb, s, part, M, K, N, chunks_per_band,
                              bands, st);
    case 16:
      return launch_cfg<G, 2>(x, pa, pb, s, part, M, K, N, chunks_per_band,
                              bands, st);
    case 32:
      return launch_cfg<G, 4>(x, pa, pb, s, part, M, K, N, chunks_per_band,
                              bands, st);
    default:
      return launch_cfg<G, 8>(x, pa, pb, s, part, M, K, N, chunks_per_band,
                              bands, st);
  }
}

}  // namespace

// x [M, K] bf16; pa [K/4, N], pb [K/8, N] uint8; s [K/G, N] f32; x, pa, pb
// and s 16-byte aligned; part [bands, M, N] f32 scratch; y [M, N] bf16. K
// splits into bands of chunks_per_band chunks of 1024 rows. Needs K % 1024
// == 0, N % 16 == 0, G in {32, 64, 128}.
extern "C" int tce_int3_matmul(const void* x, const void* pa, const void* pb,
                               const void* s, void* part, void* y, int M, int K,
                               int N, int G, int chunks_per_band, int bands,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  int err;
  switch (G) {
    case 32:
      err = launch_g<32>(x, pa, pb, s, p, M, K, N, chunks_per_band, bands, st);
      break;
    case 64:
      err = launch_g<64>(x, pa, pb, s, p, M, K, N, chunks_per_band, bands, st);
      break;
    default:
      err = launch_g<128>(x, pa, pb, s, p, M, K, N, chunks_per_band, bands,
                          st);
  }
  if (err) return err;
  const int mn = M * N;
  tce::band::reduce_bands<<<(mn + tce::band::THREADS - 1) / tce::band::THREADS,
                            tce::band::THREADS, 0, st>>>(
      p, static_cast<__nv_bfloat16*>(y), mn, bands);
  return (int)cudaGetLastError();
}
