// W4A8 fused matmul: int8 activations quantized per (row, group) at run
// time, int4 weights, int32 group dots.
//
// Replaces: tinychatengine_tpu/ops/int4_matmul.py · int4_matmul_a8
// (body _int4_a8_kernel, pallas_call sites :998 and :1045).
//
//   a_scale = max(absmax(x[m, group]), 1e-8) / 127       (fp32 division)
//   q_a     = clip(rint(x / a_scale), -127, 127)          (half to even)
//   y[m, n] = sum_g (sum_k q_a * (q - 8)) * a_scale * d[g, n]
//
// Two launches from one entry point: a tiny pass quantizes x (one warp per
// (row, group)) and writes q_a in a per-128-row permuted order that matches
// the second pass's thread mapping, so every warp reads its four int8
// activations as one broadcast 32-bit word. The second pass is a GEMV-style
// stream over the packed weights, read as stored (QM_TPU, no repack).
//
// Bound on the H100: at decode (M = 1) and small prefill buckets (M <= 100)
// the work is bound by bytes: the N*K/2 weight bytes over 3.35 TB/s. The
// design keeps many loads in flight: a block covers 128 columns (each lane
// loads 4 bytes of 16 byte rows per superblock, a coalesced 128-byte row per
// warp) and K is split over blockIdx.y until about two blocks per SM are in
// flight; a last small pass sums the K splits in a fixed order
// (deterministic). Per lane, 4 rows x 4 columns of bytes are transposed with
// __byte_perm so that one __dp4a multiplies four k of one column; codes are
// made signed (q - 8) per byte, so the zero point needs no extra term.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int COLS = 128;  // columns per block (32 lanes x 4)

// position of in-chunk index i (0..127) in the permuted q_a layout:
// warp w = i % 8 owns the bytes of rows w + 8t, t = i / 8
__device__ __forceinline__ int permuted(int i) { return (i % 8) * 16 + i / 8; }

__global__ void __launch_bounds__(THREADS) quant_act_kernel(
    const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ qa,
    float* __restrict__ ascale, int M, int K, int G) {
  const int lane = threadIdx.x % 32;
  const int ng = K / G;
  const int total = M * ng;
  const int per_lane = G / 32;  // 1, 2 or 4
  for (int wi = blockIdx.x * (THREADS / 32) + threadIdx.x / 32; wi < total;
       wi += gridDim.x * (THREADS / 32)) {
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
    const float sc = fmaxf(amax, 1e-8f) / 127.0f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (t < per_lane) {
        const float q = fminf(fmaxf(rintf(v[t] / sc), -127.f), 127.f);
        const int k = g * G + lane + 32 * t;
        qa[(size_t)m * K + (k / 128) * 128 + permuted(k % 128)] = (int8_t)q;
      }
    }
    if (lane == 0) ascale[(size_t)m * ng + g] = sc;
  }
}

template <int MT, typename ST>
__global__ void __launch_bounds__(THREADS) int4_a8_kernel(
    const uint8_t* __restrict__ w, const ST* __restrict__ s,
    const int8_t* __restrict__ qa, const float* __restrict__ ascale,
    float* __restrict__ partial, __nv_bfloat16* __restrict__ y, int M, int K,
    int N, int G) {
  __shared__ float4 red[THREADS / 32][MT][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n0 = blockIdx.x * COLS + lane * 4;
  const bool col_ok = n0 < N;
  const int m0 = blockIdx.z * MT;
  const int mcount = min(MT, M - m0);
  const int nsb = K / 256, ng = K / G;
  const int ksplit = gridDim.y;
  const int sb_begin = (int)(((long)blockIdx.y * nsb) / ksplit);
  const int sb_end = (int)(((long)(blockIdx.y + 1) * nsb) / ksplit);

  float acc[MT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[mi][c] = 0.f;

  for (int sb = sb_begin; sb < sb_end; ++sb) {
    uint32_t wr[16];  // byte rows warp + 8t of this superblock, 4 columns
#pragma unroll
    for (int t = 0; t < 16; ++t)
      wr[t] = col_ok ? *reinterpret_cast<const uint32_t*>(
                           w + (size_t)(sb * 128 + warp + 8 * t) * N + n0)
                     : 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // transpose 4 rows x 4 columns of bytes: col[c] byte j = row 4q+j
      const uint32_t R0 = wr[4 * q], R1 = wr[4 * q + 1];
      const uint32_t R2 = wr[4 * q + 2], R3 = wr[4 * q + 3];
      const uint32_t t0 = __byte_perm(R0, R1, 0x5140);
      const uint32_t t1 = __byte_perm(R2, R3, 0x5140);
      const uint32_t t2 = __byte_perm(R0, R1, 0x7362);
      const uint32_t t3 = __byte_perm(R2, R3, 0x7362);
      const uint32_t col[4] = {__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                               __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632)};
      int lo[4], hi[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        lo[c] = (int)__vsub4(col[c] & 0x0F0F0F0Fu, 0x08080808u);
        hi[c] = (int)__vsub4((col[c] >> 4) & 0x0F0F0F0Fu, 0x08080808u);
      }
      // rows warp + 32q + 8j (j = 0..3) lie in one group for G in {32, 64, 128}
      const int k_lo = sb * 256 + warp + 32 * q;
      const int g_lo = k_lo / G, g_hi = (k_lo + 128) / G;
      float d_lo[4], d_hi[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        d_lo[c] = col_ok ? tce::to_float(s[(size_t)g_lo * N + n0 + c]) : 0.f;
        d_hi[c] = col_ok ? tce::to_float(s[(size_t)g_hi * N + n0 + c]) : 0.f;
      }
      const int off = warp * 16 + 4 * q;  // permuted word of this quad
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        if (mi < mcount) {
          const int m = m0 + mi;
          const int8_t* qrow = qa + (size_t)m * K + (size_t)sb * 256;
          const int a_lo = *reinterpret_cast<const int*>(qrow + off);
          const int a_hi = *reinterpret_cast<const int*>(qrow + 128 + off);
          const float s_lo = ascale[(size_t)m * ng + g_lo];
          const float s_hi = ascale[(size_t)m * ng + g_hi];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[mi][c] += ((float)__dp4a(lo[c], a_lo, 0) * s_lo) * d_lo[c];
            acc[mi][c] += ((float)__dp4a(hi[c], a_hi, 0) * s_hi) * d_hi[c];
          }
        }
      }
    }
  }
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
    red[warp][mi][lane] = make_float4(acc[mi][0], acc[mi][1], acc[mi][2], acc[mi][3]);
  __syncthreads();
  for (int o = threadIdx.x; o < MT * COLS; o += THREADS) {
    const int mi = o / COLS, col = o % COLS;
    const int n = blockIdx.x * COLS + col;
    if (mi >= mcount || n >= N) continue;
    float v = 0.f;
#pragma unroll
    for (int wv = 0; wv < THREADS / 32; ++wv)
      v += reinterpret_cast<const float*>(&red[wv][mi][col / 4])[col % 4];
    const size_t at = (size_t)(m0 + mi) * N + n;
    if (ksplit == 1)
      y[at] = __float2bfloat16(v);
    else
      partial[(size_t)blockIdx.y * M * N + at] = v;
  }
}

__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  __nv_bfloat16* __restrict__ y, int splits,
                                  size_t mn) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int sp = 0; sp < splits; ++sp) v += partial[sp * mn + i];
    y[i] = __float2bfloat16(v);
  }
}

template <int MT, typename ST>
void launch_main(dim3 grid, cudaStream_t st, const void* w, const void* s,
                 const void* qa, const void* ascale, void* partial, void* y,
                 int M, int K, int N, int G) {
  int4_a8_kernel<MT, ST><<<grid, THREADS, 0, st>>>(
      static_cast<const uint8_t*>(w), static_cast<const ST*>(s),
      static_cast<const int8_t*>(qa), static_cast<const float*>(ascale),
      static_cast<float*>(partial), static_cast<__nv_bfloat16*>(y), M, K, N, G);
}

}  // namespace

// x [M, K] bf16 (K already padded to the packed K); w [K/2, N] uint8;
// s [K/G, N] (bf16 when scale_bf16 != 0, else f32); scratch: qa [M, K] int8,
// ascale [M, K/G] f32, partial [ksplit, M, N] f32 (unused when ksplit == 1);
// y [M, N] bf16. Needs K % 256 == 0, N % 4 == 0, G in {32, 64, 128}.
extern "C" int tce_int4_matmul_a8(const void* x, const void* w, const void* s,
                                  void* qa, void* ascale, void* partial,
                                  void* y, int M, int K, int N, int G,
                                  int scale_bf16, int ksplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int groups = M * (K / G);
  const int qblocks = std::min((groups + THREADS / 32 - 1) / (THREADS / 32), 4096);
  quant_act_kernel<<<qblocks, THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(qa),
      static_cast<float*>(ascale), M, K, G);
  const int mt = M == 1 ? 1 : 8;
  const dim3 grid((N + COLS - 1) / COLS, ksplit, (M + mt - 1) / mt);
  if (M == 1) {
    if (scale_bf16)
      launch_main<1, __nv_bfloat16>(grid, st, w, s, qa, ascale, partial, y, M, K, N, G);
    else
      launch_main<1, float>(grid, st, w, s, qa, ascale, partial, y, M, K, N, G);
  } else {
    if (scale_bf16)
      launch_main<8, __nv_bfloat16>(grid, st, w, s, qa, ascale, partial, y, M, K, N, G);
    else
      launch_main<8, float>(grid, st, w, s, qa, ascale, partial, y, M, K, N, G);
  }
  if (ksplit > 1) {
    const size_t mn = (size_t)M * N;
    const int blocks = (int)std::min((mn + 255) / 256, (size_t)4096);
    sum_splits_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(partial),
                                              static_cast<__nv_bfloat16*>(y),
                                              ksplit, mn);
  }
  return (int)cudaGetLastError();
}
