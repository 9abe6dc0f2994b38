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
// Bound on the H100: at the main path's M (128..2048 prefill rows) the
// product is bound by operations (2*M*N*K against 4 bits a weight); this
// first version runs on the CUDA cores in fp32, far under the 989 TFLOP/s
// bf16 tensor-core peak. Design: a 64x128 output tile per block, 256
// threads each owning a 4x8 register tile; K walks in steps of 32 rows
// through shared memory (x as fp32, codes unpacked once per tile, so the
// unpack is amortised over the 64 rows of the tile). The zero point is
// folded out of the inner loop as in the TPU kernel:
//   acc += (sum_k x*q - 8 * sum_k x) * d   per group.
// Later work: wgmma on bf16 codes (exact for 0..15) with TMA-fed tiles.

#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int TK = 32;
constexpr int THREADS = 256;

template <typename ST>
__global__ void __launch_bounds__(THREADS) int4_matmul_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
    const ST* __restrict__ s, __nv_bfloat16* __restrict__ y, int M, int K,
    int N, int G) {
  __shared__ float xs[TK][BM + 1];  // +1: conflict-free transposed stores
  __shared__ float cs[TK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[4][8], dot[4][8], xsum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    xsum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = dot[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += TK) {
    {  // x tile: 64 rows x 32 k, 8 bf16 (16 bytes) per thread
      const int r = tid / 4, kc = (tid % 4) * 8;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M)
        raw = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k0 + kc);
      const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) xs[kc + i][r] = __bfloat162float(v[i]);
    }
    {  // code tile: 32 k rows x 128 columns, 4 bytes per load
      const int sb = k0 / 256, within = k0 % 256;
      const int shift = within >= 128 ? 4 : 0;  // a 32-row tile lies in one plane
      const int row0 = sb * 128 + (within & 127);
      const int c4 = (tid % 32) * 4;
#pragma unroll
      for (int r = 0; r < TK / 8; ++r) {
        const int kk = tid / 32 + 8 * r;
        uint32_t b = 0u;
        if (n0 + c4 < N)
          b = *reinterpret_cast<const uint32_t*>(w + (size_t)(row0 + kk) * N + n0 + c4);
        b >>= shift;
        *reinterpret_cast<float4*>(&cs[kk][c4]) = make_float4(
            (float)(b & 15u), (float)((b >> 8) & 15u), (float)((b >> 16) & 15u),
            (float)((b >> 24) & 15u));
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
      float a[4], c[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = xs[kk][ty + 16 * i];
        xsum[i] += a[i];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) c[j] = cs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) dot[i][j] = fmaf(a[i], c[j], dot[i][j]);
    }
    __syncthreads();
    if ((k0 + TK) % G == 0) {  // group complete: apply scale and zero point
      const int g = k0 / G;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + tx + 16 * j;
        const float d = n < N ? tce::to_float(s[(size_t)g * N + n]) : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j] += (dot[i][j] - xsum[i] * 8.f) * d;
          dot[i][j] = 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) xsum[i] = 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) y[(size_t)m * N + n] = __float2bfloat16(acc[i][j]);
    }
  }
}

}  // namespace

// x [M, K] bf16 (K already padded to the packed K); w [K/2, N] uint8;
// s [K/G, N] (bf16 when scale_bf16 != 0, else f32); y [M, N] bf16.
// Needs K % 256 == 0, N % 4 == 0, G in {32, 64, 128}.
extern "C" int tce_int4_matmul(const void* x, const void* w, const void* s,
                               void* y, int M, int K, int N, int G,
                               int scale_bf16, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (scale_bf16)
    int4_matmul_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
        static_cast<const __nv_bfloat16*>(s), static_cast<__nv_bfloat16*>(y),
        M, K, N, G);
  else
    int4_matmul_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
        static_cast<const float*>(s), static_cast<__nv_bfloat16*>(y), M, K, N,
        G);
  return (int)cudaGetLastError();
}
