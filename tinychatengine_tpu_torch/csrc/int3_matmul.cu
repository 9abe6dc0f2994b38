// INT3 fused dequant matmul (the W3 experiment): y[M, N] = x[M, K] @
// ((A + 4 B - 4) * d).
//
// Replaces: tinychatengine_tpu/ops/int3_matmul.py · int3_matmul (body
// _int3_kernel, pallas_call site :154).
//
// Layout QM_TPU3, read as stored: plane A (low 2 bits) [K/4, N], four K rows
// a byte: in A-superblock s (512 K rows), byte row i bits [2j, 2j+1] hold
// k = 512 s + 128 j + i; plane B (high bit) [K/8, N], eight a byte: in
// B-superblock t (1024 K rows), byte row i bit j holds k = 1024 t + 128 j + i.
// The two planes' periods differ, so the kernel walks K in chunks of 1024
// rows: one B-superblock and the two A-superblocks beside it, byte row i of
// each covering k = 1024 t + 128 j + i for j = 0..7. Scales [K/G, N] f32.
//
// As in the TPU kernel, the zero point and the B plane stay out of the
// per-element path: per 16-row run of one group (a warp's share of a chunk's
// byte rows, at a fixed j) the two dots x . A and x . B and the row sum of x
// are kept apart and folded once, acc += (x.A + 4 x.B - 4 sum x) * d.
// Each lane reads 4 bytes of a packed row of each plane (a warp reads 128
// contiguous bytes); x stages into shared memory half a chunk (512 rows) at
// a time. K splits over blocks into bands of chunks until about two blocks
// per SM are in flight; ``tce::band::reduce_bands`` sums the bands in K
// order and rounds to bf16 once.
//
// Bound on the H100: bytes at small M (3/8 byte a weight plus the f32
// scales over 3.35 TB/s). Later work: tensor cores on bf16 codes (exact).

#include "int4_band.cuh"

namespace {

using tce::band::COLS;
using tce::band::THREADS;
using tce::band::WARPS;
constexpr int CHUNK = 1024;  // K rows of one B-superblock
constexpr int HALF = 512;    // K rows of one A-superblock
constexpr int RUN = 16;      // byte rows of a plane per warp and chunk

template <int MT>
union Smem3 {
  float xs[MT][HALF];
  float red[WARPS][MT][COLS];
};

template <int MT>
__global__ void __launch_bounds__(THREADS) int3_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ pa,
    const uint8_t* __restrict__ pb, const float* __restrict__ s,
    float* __restrict__ part, int M, int K, int N, int G, int chunks_per_band) {
  __shared__ Smem3<MT> sm;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int m0 = blockIdx.y * MT, rows = min(MT, M - m0);
  const int col = blockIdx.x * COLS + lane * 4;
  const int i0 = warp * RUN;
  const int c0 = blockIdx.z * chunks_per_band;
  const int c1 = min(c0 + chunks_per_band, K / CHUNK);
  float acc[MT][4] = {};

  for (int ch = c0; ch < c1; ++ch) {
    uint32_t b[RUN];
#pragma unroll
    for (int i = 0; i < RUN; ++i)
      b[i] = col < N ? __ldg(reinterpret_cast<const uint32_t*>(
                           pb + (size_t)(ch * 128 + i0 + i) * N + col))
                     : 0u;
    for (int h = 0; h < 2; ++h) {
      const int k0 = ch * CHUNK + h * HALF;
      for (int i = tid; i < MT * HALF; i += THREADS) {
        const int r = i / HALF, c = i % HALF;
        sm.xs[r][c] =
            r < rows ? __bfloat162float(x[(size_t)(m0 + r) * K + k0 + c]) : 0.f;
      }
      __syncthreads();
      uint32_t a[RUN];
#pragma unroll
      for (int i = 0; i < RUN; ++i)
        a[i] = col < N ? __ldg(reinterpret_cast<const uint32_t*>(
                             pa + (size_t)((2 * ch + h) * 128 + i0 + i) * N + col))
                       : 0u;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {  // K rows k0 + 128 jj + i0 + i
        const int j = 4 * h + jj;
        float da[MT][4], db[MT][4], xsum[MT];
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          xsum[r] = 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c) da[r][c] = db[r][c] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < RUN; ++i) {
          float xv[MT];
#pragma unroll
          for (int r = 0; r < MT; ++r) {
            xv[r] = sm.xs[r][jj * 128 + i0 + i];
            xsum[r] += xv[r];
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float qa = (float)((a[i] >> (8 * c + 2 * jj)) & 3u);
            const float qb = (float)((b[i] >> (8 * c + j)) & 1u);
#pragma unroll
            for (int r = 0; r < MT; ++r) {
              da[r][c] = fmaf(xv[r], qa, da[r][c]);
              db[r][c] = fmaf(xv[r], qb, db[r][c]);
            }
          }
        }
        const int g = (k0 + jj * 128 + i0) / G;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float d = col < N ? s[(size_t)g * N + col + c] : 0.f;
#pragma unroll
          for (int r = 0; r < MT; ++r)
            acc[r][c] = fmaf(da[r][c] + 4.f * db[r][c] - 4.f * xsum[r], d,
                             acc[r][c]);
        }
      }
      __syncthreads();  // xs is rewritten for the next half
    }
  }

  tce::band::write_partial<MT>(acc, sm.red, part, M, N, m0, blockIdx.x,
                               blockIdx.z);
}

}  // namespace

// x [M, K] bf16; pa [K/4, N], pb [K/8, N] uint8; s [K/G, N] f32; part
// [bands, M, N] f32 scratch; y [M, N] bf16. K splits into bands of
// chunks_per_band chunks of 1024 rows. Needs K % 1024 == 0, N % 4 == 0,
// G in {32, 64, 128}. Rows go 8 to a block, or 1 at M = 1.
extern "C" int tce_int3_matmul(const void* x, const void* pa, const void* pb,
                               const void* s, void* part, void* y, int M, int K,
                               int N, int G, int chunks_per_band, int bands,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* ap = static_cast<const uint8_t*>(pa);
  const auto* bp = static_cast<const uint8_t*>(pb);
  const auto* sp = static_cast<const float*>(s);
  float* p = static_cast<float*>(part);
  return tce::band::launch_split(
      [&](auto mt, dim3 grid) {
        int3_kernel<decltype(mt)::value><<<grid, THREADS, 0, st>>>(
            xp, ap, bp, sp, p, M, K, N, G, chunks_per_band);
      },
      p, y, M, N, bands, st);
}
