// The split-K int4 contraction on the CUDA cores: ``int4_matmul``'s band
// route (M <= 8). One block computes the f32 sum of y[m, n] over a band of
// K (whole superblocks) for up to MT rows and 128 columns, and writes it to
// a [bands, M, N] scratch; ``reduce_bands`` sums the bands in K order and
// rounds to bf16 (deterministic, no atomics). ``reduce_bands`` also ends
// the tensor-core kernels that write band sums (K-outer, GLU, int3).
//
// Weights in the QM_TPU layout [K/2, N] uint8, read as stored: byte row i
// of superblock sb holds k = 256 sb + i in its low nibble and 256 sb + 128
// + i in its high nibble. Scales [K/G, N], bf16 or f32 (ST). Each lane reads
// 4 bytes of a packed row (a warp reads 128 contiguous bytes, coalesced
// along N); the 8 warps split a superblock's 128 packed rows 16 apiece, so
// a warp's rows of each nibble plane lie in one group (G in 32, 64, 128)
// and the scale is applied once per 16 rows:
//   acc += (sum_i x_i * (q_i - 8)) * d.
// The bf16 activation rows of a superblock are staged into shared memory
// as f32.
#pragma once

#include "common.cuh"

namespace tce {
namespace band {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 128;                   // columns per block: 32 lanes x 4
constexpr int SB = 256;                     // K rows per superblock
constexpr int ROWS_PER_WARP = 128 / WARPS;  // packed rows of a superblock each

template <int MT>
struct Smem {
  float xs[MT][SB];               // the superblock's activation rows
  float red[WARPS][MT][COLS];     // the warps' sums, reduced in fixed order
};

// the block's sums: each lane holds acc[r][c] of rows m0 + r (at most MT)
// and columns n_tile * 128 + 4 lane + c, one set per warp; the warps' sets
// are summed in warp order through ``red`` and written to part[band];
// ends with the block synchronised (red may be rewritten after)
template <int MT>
__device__ __forceinline__ void write_partial(
    const float (&acc)[MT][4], float (&red)[WARPS][MT][COLS],
    float* __restrict__ part, int M, int N, int m0, int n_tile, int band) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rows = min(MT, M - m0);
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[warp][r][lane * 4 + c] = acc[r][c];
  __syncthreads();
  for (int i = tid; i < MT * COLS; i += THREADS) {
    const int r = i / COLS, c = i % COLS;
    const int n = n_tile * COLS + c;
    if (r < rows && n < N) {
      float t = 0.f;
#pragma unroll
      for (int ww = 0; ww < WARPS; ++ww) t += red[ww][r][c];
      part[((size_t)band * M + m0 + r) * N + n] = t;
    }
  }
  __syncthreads();
}

// f32 sum over superblocks [sb0, sb1) of rows m0.. (at most MT) of x [M,
// K] and columns of tile n_tile into part[band]; ends with the block
// synchronised
template <typename ST, int MT>
__device__ __forceinline__ void band_partial(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
    const ST* __restrict__ s, float* __restrict__ part, int M, int K, int N,
    int G, int m0, int n_tile, int sb0, int sb1, int band, Smem<MT>& sm) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rows = min(MT, M - m0);
  const int col = n_tile * COLS + lane * 4;
  const int i0 = warp * ROWS_PER_WARP;
  float acc[MT][4] = {};

  for (int sb = sb0; sb < sb1; ++sb) {
    for (int i = tid; i < MT * SB; i += THREADS) {
      const int r = i / SB, c = i % SB;
      sm.xs[r][c] =
          r < rows ? __bfloat162float(x[(size_t)(m0 + r) * K + sb * SB + c])
                   : 0.f;
    }
    __syncthreads();
    uint32_t b[ROWS_PER_WARP];
    const uint8_t* wp = w + (size_t)(sb * 128 + i0) * N + col;
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i)
      b[i] = col < N ? __ldg(reinterpret_cast<const uint32_t*>(wp + (size_t)i * N))
                     : 0u;
#pragma unroll
    for (int plane = 0; plane < 2; ++plane) {
      float dot[MT][4];
#pragma unroll
      for (int r = 0; r < MT; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) dot[r][c] = 0.f;
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float q = (float)((b[i] >> (8 * c + 4 * plane)) & 15u) - 8.f;
#pragma unroll
          for (int r = 0; r < MT; ++r)
            dot[r][c] = fmaf(sm.xs[r][plane * 128 + i0 + i], q, dot[r][c]);
        }
      }
      const int g = (sb * SB + plane * 128 + i0) / G;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float d = col < N ? to_float(s[(size_t)g * N + col + c]) : 0.f;
#pragma unroll
        for (int r = 0; r < MT; ++r) acc[r][c] = fmaf(dot[r][c], d, acc[r][c]);
      }
    }
    __syncthreads();  // xs is rewritten for the next superblock
  }

  write_partial<MT>(acc, sm.red, part, M, N, m0, n_tile, band);
}

// one (columns, rows, band) item of a [N/128, M/MT, bands] grid
template <typename ST, int MT>
__global__ void __launch_bounds__(THREADS) band_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
    const ST* __restrict__ s, float* __restrict__ part, int M, int K, int N,
    int G, int sb_per_band) {
  __shared__ Smem<MT> sm;
  const int nsb = K / SB;
  const int sb0 = blockIdx.z * sb_per_band;
  band_partial<ST, MT>(x, w, s, part, M, K, N, G, blockIdx.y * MT,
                       blockIdx.x, sb0, min(sb0 + sb_per_band, nsb),
                       blockIdx.z, sm);
}

// y[i] = bf16(sum over bands of part[band][i]), bands in K order
__global__ void __launch_bounds__(THREADS) reduce_bands(
    const float* __restrict__ part, __nv_bfloat16* __restrict__ y, int MN,
    int bands) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= MN) return;
  float v = 0.f;
  for (int z = 0; z < bands; ++z) v += part[(size_t)z * MN + i];
  y[i] = __float2bfloat16(v);
}

// the band grid over x [M, K]: blocks of 128 columns and 8 rows (1 at M =
// 1) in ``bands`` bands of sb_per_band superblocks, then ``reduce_bands``
// sums part into y. Returns cudaGetLastError()
template <typename ST>
int launch_bands(const void* x, const void* w, const void* s, float* part,
                 void* y, int M, int K, int N, int G, int sb_per_band,
                 int bands, cudaStream_t st) {
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* sp = static_cast<const ST*>(s);
  const int tiles = (N + COLS - 1) / COLS;
  if (M == 1)
    band_kernel<ST, 1><<<dim3(tiles, 1, bands), THREADS, 0, st>>>(
        xp, wp, sp, part, M, K, N, G, sb_per_band);
  else
    band_kernel<ST, 8><<<dim3(tiles, (M + 7) / 8, bands), THREADS, 0, st>>>(
        xp, wp, sp, part, M, K, N, G, sb_per_band);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int mn = M * N;
  reduce_bands<<<(mn + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      part, static_cast<__nv_bfloat16*>(y), mn, bands);
  return (int)cudaGetLastError();
}

}  // namespace band
}  // namespace tce
