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
// M <= 8 a weight byte feeds at most 16 multiply-adds): a StarCoder serving
// tick's 161 calls move 7.97 GB of codes and scales, 2.39 ms. Three kernels
// launched from one entry point:
// - the norm, when there is one: one block a row computes the row's
//   statistics in the plain version's f32 op order and writes the
//   normalised, bf16-rounded x into a workspace [M, K]. The statistics are
//   taken once per call; the CUDA-core kernel this replaced took them in
//   every block, a pass over M * K of x per block (393 KB at fc_out).
// - the contraction of csrc/int4_mma.cuh on the tensor cores (the TPU
//   kernel's product runs on its matrix unit too): transposed, 16 weight
//   columns are the m16 operand and the rows the n8 one, so a serving
//   tick's 8 rows fill mma.sync m16n8k16 with no padding; exact codes
//   q - 8 in bf16 into a per-group f32 fragment folded with its f32 scale;
//   weights, x and scales by cp.async into a two-stage ring. One row (the
//   Engine's decode) runs the same route: it measured faster than the
//   CUDA-core loop at every decode shape (PERF.md), so a row's bits do not
//   depend on how many rows ride along. K is split over blockIdx.z until
//   about eight blocks per SM are launched, a function of K and N alone at
//   M <= 8 (the wrapper's ``fused_kernel_split``).
// - the epilogue: one thread per output element sums the splits in a fixed
//   order (deterministic) and applies RoPE, the bias and the residual. RoPE
//   pairs column c with c +- D/2: the epilogue reads both sums, so no
//   column tiling has to keep a head together.

#include "int4_mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

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

// the block's pass over one row of x: the sum of x (shift == null) or of
// (x - *shift)^2, each thread over 8 values 2048 apart, then the warps' sums
// in warp order; every thread returns the total
__device__ __forceinline__ float row_sum(const __nv_bfloat16* __restrict__ x,
                                         int K, bool squares,
                                         const float* shift, float* scratch) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float v = 0.f;
  for (int k = threadIdx.x * 8; k < K; k += THREADS * 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(x + k);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float f = __bfloat162float(h[j]);
      if (shift) f = __fsub_rn(f, *shift);
      v = __fadd_rn(v, squares ? __fmul_rn(f, f) : f);
    }
  }
  const float t = tce::warp_sum(v);
  if (lane == 0) scratch[warp] = t;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < WARPS; ++w) total += scratch[w];
  __syncthreads();  // scratch is rewritten by the next pass
  return total;
}

// one block a row: the row's statistics in f32 (JAX's op order; a mean is
// the sum divided by K), then the row normalised and rounded to bf16 into
// xn, the contraction's operand
__global__ void __launch_bounds__(THREADS) fused_norm_kernel(
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ xn,
    int K, Norm norm) {
  __shared__ float scratch[WARPS];
  const __nv_bfloat16* xr = x + (size_t)blockIdx.x * K;
  const bool layer_norm = norm.b != nullptr;
  const float fk = (float)K;
  float mean = 0.f, sq;
  if (layer_norm) {
    mean = __fdiv_rn(row_sum(xr, K, false, nullptr, scratch), fk);
    sq = row_sum(xr, K, true, &mean, scratch);
  } else {
    sq = row_sum(xr, K, true, nullptr, scratch);
  }
  const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(sq, fk), norm.eps));
  for (int k = threadIdx.x * 8; k < K; k += THREADS * 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + k);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
    uint4 out;
    __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float f = __bfloat162float(h[j]);
      const float wk = load_f(norm.w, norm.w_bf16, k + j);
      if (layer_norm)
        f = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f, mean), rstd), wk),
                      load_f(norm.b, norm.b_bf16, k + j));
      else
        f = __fmul_rn(__fmul_rn(f, rstd), wk);
      o[j] = __float2bfloat16(f);
    }
    *reinterpret_cast<uint4*>(xn + (size_t)blockIdx.x * K + k) = out;
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

}  // namespace

// x [M, K] bf16 (16-byte aligned); w [K/2, N] uint8; s [K/G, N] (bf16 when
// scale_bf16 != 0, else f32), w and s 16-byte aligned; part [ksplit, M, N]
// f32 scratch; y [M, N] bf16. K splits into ksplit ranges of sb_per_split
// superblocks. norm_w / norm_b [K], bias [N]: bf16 or f32 by their flags,
// null when absent (norm_b only with norm_w); xn [M, K] bf16 scratch for
// the normalised x when norm_w is set. cos / sin [M, head_dim] f32 and
// qk_cols > 0 for RoPE, else null and 0. res [M, N] bf16 or null. Needs
// K % 256 == 0, N % 16 == 0, G in {32, 64, 128}, qk_cols % head_dim == 0.
extern "C" int tce_int4_matmul_fused(
    const void* x, const void* w, const void* s, int scale_bf16, void* part,
    void* y, int M, int K, int N, int G, int sb_per_split, int ksplit,
    const void* norm_w, int norm_w_bf16, const void* norm_b, int norm_b_bf16,
    float eps, const void* cos_t, const void* sin_t, int qk_cols, int head_dim,
    const void* bias, int bias_bf16, const void* res, void* xn,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  const void* xs = x;
  if (norm_w) {
    const Norm norm{norm_w, norm_b, norm_w_bf16, norm_b_bf16, eps};
    fused_norm_kernel<<<M, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(xn),
        K, norm);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    xs = xn;
  }
  const int err =
      scale_bf16 ? tce::mma4::launch_mma<__nv_bfloat16>(
                       xs, w, s, p, M, K, N, G, sb_per_split, ksplit, st)
                 : tce::mma4::launch_mma<float>(xs, w, s, p, M, K, N, G,
                                                sb_per_split, ksplit, st);
  if (err) return err;
  const size_t total = (size_t)M * N;
  fused_epilogue_kernel<<<(unsigned)((total + THREADS - 1) / THREADS), THREADS,
                          0, st>>>(
      p, static_cast<__nv_bfloat16*>(y), M, N, ksplit,
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      qk_cols, head_dim, bias, bias_bf16,
      static_cast<const __nv_bfloat16*>(res));
  return (int)cudaGetLastError();
}
