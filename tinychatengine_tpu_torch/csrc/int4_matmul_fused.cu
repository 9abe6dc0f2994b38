// Decode matmul with its glue folded in:
//   y = rope(norm(x) @ ((q - 8) * d)) (+ bias) (+ residual).
//
// Replaces: tinychatengine_tpu/ops/int4_matmul.py · int4_matmul_fused
// (body _fused_kernel, pallas_call site :687).
//
// x [M, K] bf16 (M = decode rows: 1 for Engine, up to 8 per serving tick);
// weights in the QM_TPU layout [K/2, N] uint8 read as stored (byte row i of
// superblock sb holds k = 256 sb + i in its low nibble and 256 sb + 128 + i
// in its high nibble); scales [K/G, N] bf16 or f32. The wrapper offsets the
// weight, scale, norm and bias pointers to the layer. Optional parts: the
// norm weight [K] (RMSNorm; LayerNorm when a norm bias [K] rides along),
// cos/sin [M, D] f32 for rotate-half RoPE on the leading qk_cols columns,
// a bias [N] and a residual [M, N] bf16.
//
// Rounding points, in order (those of the TPU kernel): the normalised x is
// rounded to bf16 as the dot consumes it; the per-group products use the
// exact codes and f32 scales; the output is rounded to bf16; RoPE runs in
// f32 on bf16 values and rounds once; the bias (rounded to bf16 first) and
// the residual are each added in f32 and rounded. Every f32 multiply and add
// of the norm and the epilogues is written with __fmul_rn / __fadd_rn so
// nvcc does not contract it into an FMA (the plain version has none).
//
// Bound on the H100: bytes, the N * K / 2 weight bytes over 3.35 TB/s (at
// M <= 8 a weight byte feeds at most 16 multiply-adds). Design, for a simple
// kernel that keeps enough loads in flight:
// - a block covers 128 columns (each lane 4 bytes of a packed row, a
//   coalesced 128-byte row per warp) and M <= 8 rows (MT = 1 at M = 1 for
//   fewer registers); its 8 warps split each superblock's 128 packed rows
//   16 apiece, so a warp's rows lie in one group of each nibble plane;
// - K is split over blockIdx.z until about two blocks per SM are in flight
//   (llama3_8b's down, N 4096, has only 32 column tiles); every block writes
//   its f32 partial sums, and a second small kernel, launched from the same
//   entry point, sums the splits in a fixed order (deterministic) and
//   applies the epilogues. RoPE pairs column c with c +- D/2: the epilogue
//   reads both sums, so no column tiling has to keep a head together;
// - the norm needs the whole row before any dot: each block computes its
//   rows' statistics itself, a pass over x (M * K bf16, from L2), then
//   normalises each 256-wide chunk of x into shared memory as it streams the
//   superblock's weights. Nothing of size K is staged (fc_out's K is 24576).
// Later work: tensor cores and a TMA-fed pipeline.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 128;                  // columns per block: 32 lanes x 4
constexpr int SB = 256;                    // K rows per superblock
constexpr int ROWS_PER_WARP = 128 / WARPS; // packed rows of a superblock each

struct Norm {
  const void* w;  // [K] or null
  const void* b;  // [K] or null (LayerNorm when set)
  int w_bf16, b_bf16;
  float eps;
};

__device__ __forceinline__ float load_f(const void* p, int is_bf16, size_t i) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

// sums v[r] over the block; every thread gets the totals in out[r]
template <int MT>
__device__ __forceinline__ void block_sum(float (&v)[MT], float* scratch,
                                          float* out) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    const float t = tce::warp_sum(v[r]);
    if (lane == 0) scratch[warp * MT + r] = t;
  }
  __syncthreads();
  if (threadIdx.x < MT) {
    float t = 0.f;
    for (int w = 0; w < WARPS; ++w) t += scratch[w * MT + threadIdx.x];
    out[threadIdx.x] = t;
  }
  __syncthreads();
}

// pass over the rows' x: sum of x (shift == null) or of (x - shift[r])^2
template <int MT>
__device__ __forceinline__ void row_sums(const __nv_bfloat16* __restrict__ x,
                                         int rows, int K, bool squares,
                                         const float* shift, float* scratch,
                                         float* out) {
  float v[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) v[r] = 0.f;
  for (int k = threadIdx.x * 8; k < K; k += THREADS * 8) {
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      if (r >= rows) continue;
      const uint4 raw =
          *reinterpret_cast<const uint4*>(x + (size_t)r * K + k);
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float f = __bfloat162float(h[j]);
        if (shift) f = __fsub_rn(f, shift[r]);
        v[r] = __fadd_rn(v[r], squares ? __fmul_rn(f, f) : f);
      }
    }
  }
  block_sum<MT>(v, scratch, out);
}

template <typename ST, int MT>
__global__ void __launch_bounds__(THREADS) fused_matmul_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
    const ST* __restrict__ s, float* __restrict__ part, int M, int K, int N,
    int G, int sb_per_split, Norm norm) {
  __shared__ float xs[MT][SB];
  __shared__ float red[WARPS][MT][COLS];
  __shared__ float mean_s[MT], rstd_s[MT];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int m0 = blockIdx.y * MT;
  const int rows = min(MT, M - m0);
  const __nv_bfloat16* xb = x + (size_t)m0 * K;
  const bool layer_norm = norm.b != nullptr;
  float* scratch = &red[0][0][0];

  if (norm.w) {  // the rows' statistics, in f32 (JAX's op order)
    const float fk = (float)K;  // a mean is the sum divided by K
    if (layer_norm) {
      row_sums<MT>(xb, rows, K, false, nullptr, scratch, mean_s);
      if (tid < MT) mean_s[tid] = __fdiv_rn(mean_s[tid], fk);
      __syncthreads();
      row_sums<MT>(xb, rows, K, true, mean_s, scratch, rstd_s);
    } else {
      row_sums<MT>(xb, rows, K, true, nullptr, scratch, rstd_s);
    }
    if (tid < MT)
      rstd_s[tid] = rsqrtf(__fadd_rn(__fdiv_rn(rstd_s[tid], fk), norm.eps));
    __syncthreads();
  }

  const int nsb = K / SB;
  const int sb0 = blockIdx.z * sb_per_split;
  const int sb1 = min(sb0 + sb_per_split, nsb);
  const int col = blockIdx.x * COLS + lane * 4;
  const int i0 = warp * ROWS_PER_WARP;  // this warp's packed rows
  float acc[MT][4];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int sb = sb0; sb < sb1; ++sb) {
    // the superblock's 256 k of each row, normalised and rounded to bf16
    for (int i = tid; i < MT * (SB / 8); i += THREADS) {
      const int r = i / (SB / 8), c = (i % (SB / 8)) * 8;
      const int k0 = sb * SB + c;
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
      if (r < rows) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(xb + (size_t)r * K + k0);
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float f = __bfloat162float(h[j]);
          if (norm.w) {
            const float wk = load_f(norm.w, norm.w_bf16, k0 + j);
            if (layer_norm)
              f = __fadd_rn(
                  __fmul_rn(__fmul_rn(__fsub_rn(f, mean_s[r]), rstd_s[r]), wk),
                  load_f(norm.b, norm.b_bf16, k0 + j));
            else
              f = __fmul_rn(__fmul_rn(f, rstd_s[r]), wk);
            f = tce::round_bf16(f);
          }
          v[j] = f;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) xs[r][c + j] = v[j];
    }
    __syncthreads();

    uint32_t b[ROWS_PER_WARP];
    const uint8_t* wp = w + (size_t)(sb * 128 + i0) * N + col;
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i)
      b[i] = col < N ? __ldg(reinterpret_cast<const uint32_t*>(wp + (size_t)i * N))
                     : 0u;
    float dlo[MT][4], dhi[MT][4];
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) dlo[r][c] = dhi[r][c] = 0.f;
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float qlo = (float)((b[i] >> (8 * c)) & 15u) - 8.f;
        const float qhi = (float)((b[i] >> (8 * c + 4)) & 15u) - 8.f;
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          dlo[r][c] = fmaf(xs[r][i0 + i], qlo, dlo[r][c]);
          dhi[r][c] = fmaf(xs[r][128 + i0 + i], qhi, dhi[r][c]);
        }
      }
    }
    // the warp's 16 rows of each plane lie in one group (G >= 32)
    const int glo = (sb * SB + i0) / G, ghi = (sb * SB + 128 + i0) / G;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool in = col + c < N;
      const float slo = in ? tce::to_float(s[(size_t)glo * N + col + c]) : 0.f;
      const float shi = in ? tce::to_float(s[(size_t)ghi * N + col + c]) : 0.f;
#pragma unroll
      for (int r = 0; r < MT; ++r)
        acc[r][c] += dlo[r][c] * slo + dhi[r][c] * shi;
    }
    __syncthreads();  // xs is rewritten for the next superblock
  }

  // sum the warps' partials in a fixed order, one f32 value per (row, col)
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[warp][r][lane * 4 + c] = acc[r][c];
  __syncthreads();
  for (int i = tid; i < MT * COLS; i += THREADS) {
    const int r = i / COLS, c = i % COLS;
    const int n = blockIdx.x * COLS + c;
    if (r < rows && n < N) {
      float t = 0.f;
#pragma unroll
      for (int ww = 0; ww < WARPS; ++ww) t += red[ww][r][c];
      part[((size_t)blockIdx.z * M + m0 + r) * N + n] = t;
    }
  }
}

// one thread per output element: the K splits summed in order, then the
// epilogues with the TPU kernel's rounding points
__global__ void __launch_bounds__(THREADS) fused_epilogue_kernel(
    const float* __restrict__ part, __nv_bfloat16* __restrict__ y, int M,
    int N, int ksplit, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, int qk_cols, int D, const void* bias,
    int bias_bf16, const __nv_bfloat16* __restrict__ res) {
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (size_t)M * N) return;
  const int m = (int)(i / N), n = (int)(i % N);
  const float* pm = part + (size_t)m * N;
  const size_t stride = (size_t)M * N;
  float v = 0.f;
  for (int z = 0; z < ksplit; ++z) v += pm[z * stride + n];
  v = tce::round_bf16(v);
  if (n < qk_cols) {  // rotate-half: the partner is c + D/2 or c - D/2
    const int j = n % D, half = D / 2;
    const int pn = j < half ? n + half : n - half;
    float p = 0.f;
    for (int z = 0; z < ksplit; ++z) p += pm[z * stride + pn];
    p = tce::round_bf16(p);
    const float rot = j < half ? -p : p;
    v = tce::round_bf16(__fadd_rn(__fmul_rn(v, cos_t[(size_t)m * D + j]),
                                  __fmul_rn(rot, sin_t[(size_t)m * D + j])));
  }
  if (bias)
    v = tce::round_bf16(
        __fadd_rn(v, tce::round_bf16(load_f(bias, bias_bf16, n))));
  if (res) v = __fadd_rn(v, __bfloat162float(res[i]));
  y[i] = __float2bfloat16(v);
}

template <typename ST, int MT>
void launch_main(const void* x, const void* w, const void* s, float* part,
                 int M, int K, int N, int G, int sb_per_split, int ksplit,
                 Norm norm, cudaStream_t st) {
  const dim3 grid((N + COLS - 1) / COLS, (M + MT - 1) / MT, ksplit);
  fused_matmul_kernel<ST, MT><<<grid, THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
      static_cast<const ST*>(s), part, M, K, N, G, sb_per_split, norm);
}

}  // namespace

// x [M, K] bf16 (16-byte aligned); w [K/2, N] uint8; s [K/G, N] (bf16 when
// scale_bf16 != 0, else f32); part [ksplit, M, N] f32 scratch; y [M, N]
// bf16. K splits into ksplit ranges of sb_per_split superblocks. norm_w /
// norm_b [K], bias [N]: bf16 or f32 by their flags, null when absent
// (norm_b only with norm_w). cos / sin [M, head_dim] f32 and qk_cols > 0
// for RoPE, else null and 0. res [M, N] bf16 or null. Needs K % 256 == 0,
// N % 4 == 0, G in {32, 64, 128}, qk_cols % head_dim == 0. Rows go 8 to a
// block, or 1 at M = 1.
extern "C" int tce_int4_matmul_fused(
    const void* x, const void* w, const void* s, int scale_bf16, void* part,
    void* y, int M, int K, int N, int G, int sb_per_split, int ksplit,
    const void* norm_w, int norm_w_bf16, const void* norm_b, int norm_b_bf16,
    float eps, const void* cos_t, const void* sin_t, int qk_cols, int head_dim,
    const void* bias, int bias_bf16, const void* res, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Norm norm{norm_w, norm_b, norm_w_bf16, norm_b_bf16, eps};
  float* p = static_cast<float*>(part);
  if (M == 1) {
    if (scale_bf16)
      launch_main<__nv_bfloat16, 1>(x, w, s, p, M, K, N, G, sb_per_split,
                                    ksplit, norm, st);
    else
      launch_main<float, 1>(x, w, s, p, M, K, N, G, sb_per_split, ksplit,
                            norm, st);
  } else {
    if (scale_bf16)
      launch_main<__nv_bfloat16, 8>(x, w, s, p, M, K, N, G, sb_per_split,
                                    ksplit, norm, st);
    else
      launch_main<float, 8>(x, w, s, p, M, K, N, G, sb_per_split, ksplit,
                            norm, st);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)M * N;
  fused_epilogue_kernel<<<(unsigned)((total + THREADS - 1) / THREADS), THREADS,
                          0, st>>>(
      p, static_cast<__nv_bfloat16*>(y), M, N, ksplit,
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t), qk_cols,
      head_dim, bias, bias_bf16, static_cast<const __nv_bfloat16*>(res));
  return (int)cudaGetLastError();
}
