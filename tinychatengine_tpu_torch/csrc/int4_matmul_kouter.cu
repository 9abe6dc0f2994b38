// W4A16 matmul at small M with K walked in bands (the K-outer route), and
// the down projection from the fused gate_up output (silu(gate) * up made
// by a first kernel, then the same contraction).
//
// Replaces: tinychatengine_tpu/ops/int4_matmul.py · _int4_matmul_kouter
// (body _kouter_kernel, pallas_call site :394) and · int4_matmul_glu
// (body _glu_kernel, pallas_call site :849).
//
// K-outer: y[M, N] = x[M, K] @ ((q - 8) * d) over one layer of a stacked
// weight (the wrapper offsets the pointers). The TPU kernel walks a K band's
// weight rows with N innermost, keeps x resident across the band and a
// full-N f32 accumulator in VMEM, and takes each group's product on its
// matrix unit: jnp.dot(x_g, codes_g) in f32 on bf16 codes 0..15, then
// acc += (dot - 8 sum x_g) * d. Here the band is a grid dimension: one
// block per (128 columns, a row tile, K band of block_k rows from the
// route's table), each streaming its band's [block_k / 2, 128] slab of the
// K-major packed layout (coalesced along N) and writing f32 band sums; a
// second kernel (``reduce_bands``) sums the bands in K order and rounds to
// bf16 once. M runs from 1 (decode) to 496 (prompt buckets). The product
// is the tensor-core contraction of csrc/int4_mma.cuh (exact codes q - 8
// in bf16, mma.sync m16n8k16 into a per-group f32 fragment, acc = fma(dot,
// d, acc) per group; a two-stage cp.async ring). A block covers 8, 16, 32
// or 64 rows by M (row tiles beyond as grid rows), so a column tile's
// weight bytes leave device memory once per 64 rows, where the CUDA-core
// loop this replaced (csrc/int4_band.cuh ``band_partial``, one f32 FMA per
// code per row) read them once per 8. One row (decode) runs the same
// route: it measured faster than the CUDA-core loop at all four of
// llama3_8b's stacked shapes (PERF.md), so a row's bits do not depend on M.
// Bound on the H100 at gate_up (K 4096, N 28672): bytes, the 58.7 MB of
// codes and 1.8 MB of scales over 3.35 TB/s, 0.018 ms at one row and
// 0.019 ms at 64 rows, where the 15.0 GFLOP take 0.015 ms at the bf16
// tensor-core peak (989 TFLOP/s); the CUDA-core loop's f32 FMAs alone took
// 0.22 ms there. The f32 band sums ([bands, M, N], written and read once)
// add 8 bytes an output per band; at 496 rows the product is bound by the
// mma.sync rate.
//
// GLU: y = bf16(silu(g) * u) @ ((q - 8) * d), g and u the two halves of the
// fused gate_up output gu [M, 2F] (bf16), F columns apart. The TPU kernel
// makes its K tile of the activation in VMEM before each product; here a
// first kernel (``glu_act_kernel``) makes the whole bf16 activation act
// [M, F] once (sigmoid in f32, rounded to bf16 as the TPU kernel does;
// 229 KB at 8 rows), and the K-outer kernel's tensor-core contraction
// (``mma_band_kernel``) runs on it, F split over bands from F and N alone
// up to 8 rows (the wrapper's ``glu_split``), ``reduce_bands`` adding the
// bands in K order. The CUDA-core loop this replaced remade the activation
// in every column tile's blocks, but its time went to the loop's f32 FMAs
// and to re-reading the weights once per 8 rows: it ran as long as the
// same loop on an activation made in advance (PERF.md). The contraction is
// launched with programmatic dependent launch: each block requests its
// first weights and scales while the activation kernel runs, then waits
// for it (griddepcontrol.wait) before it requests act. Bound as K-outer
// at down: the 29.4 MB of codes and scales, 0.009 ms; the activation adds
// 2 bytes an element of gu read and of act written and read.

#include "int4_band.cuh"
#include "int4_mma.cuh"

namespace {

constexpr int ACT_THREADS = 256;

// act[m, f] = bf16(sigmoid(g) * g * u), g = gu[m, f], u = gu[m, F + f]:
// sigmoid(g) = 1 / (1 + exp(-g)) in f32, no contraction into FMAs; one
// thread 8 elements (16 bytes of g, of u and of act). Lets the dependent
// contraction start at once: it waits for this grid before it reads act.
__global__ void __launch_bounds__(ACT_THREADS) glu_act_kernel(
    const __nv_bfloat16* __restrict__ gu, __nv_bfloat16* __restrict__ act,
    int M, int F) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const size_t i = ((size_t)blockIdx.x * ACT_THREADS + threadIdx.x) * 8;
  if (i >= (size_t)M * F) return;
  const size_t m = i / F, f = i % F;
  const uint4 graw = *reinterpret_cast<const uint4*>(gu + m * 2 * F + f);
  const uint4 uraw = *reinterpret_cast<const uint4*>(gu + m * 2 * F + F + f);
  const __nv_bfloat16* g8 = reinterpret_cast<const __nv_bfloat16*>(&graw);
  const __nv_bfloat16* u8 = reinterpret_cast<const __nv_bfloat16*>(&uraw);
  uint4 out;
  __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float g = __bfloat162float(g8[j]);
    const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g)));
    o[j] = __float2bfloat16(__fmul_rn(__fmul_rn(sig, g),
                                      __bfloat162float(u8[j])));
  }
  *reinterpret_cast<uint4*>(act + i) = out;
}

// y[i] = bf16(sum over bands of part[band][i]), bands in K order
int reduce(float* part, void* y, int M, int N, int bands, cudaStream_t st) {
  const int mn = M * N;
  tce::band::reduce_bands<<<(mn + tce::band::THREADS - 1) / tce::band::THREADS,
                            tce::band::THREADS, 0, st>>>(
      part, static_cast<__nv_bfloat16*>(y), mn, bands);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, K] bf16 (K the packed K); w [K/2, N] uint8; s [K/G, N] (bf16 when
// scale_bf16 != 0, else f32); x, w and s 16-byte aligned; part [bands, M,
// N] f32 scratch; y [M, N] bf16. K splits into bands of sb_per_band
// superblocks. Needs K % 256 == 0, N % 16 == 0, G in {32, 64, 128}.
extern "C" int tce_int4_matmul_kouter(const void* x, const void* w,
                                      const void* s, int scale_bf16,
                                      void* part, void* y, int M, int K, int N,
                                      int G, int sb_per_band, int bands,
                                      void* stream) {
  float* p = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = scale_bf16
                      ? tce::mma4::launch_mma<__nv_bfloat16>(
                            x, w, s, p, M, K, N, G, sb_per_band, bands, st)
                      : tce::mma4::launch_mma<float>(x, w, s, p, M, K, N, G,
                                                     sb_per_band, bands, st);
  return err ? err : reduce(p, y, M, N, bands, st);
}

// gu [M, 2F] bf16; w [F/2, N] uint8; s [F/G, N] (bf16 when scale_bf16 !=
// 0, else f32); gu, w and s 16-byte aligned; act [M, F] bf16 and part
// [bands, M, N] f32 scratch; y [M, N] bf16. F splits into bands of
// sb_per_band superblocks. Needs F % 256 == 0, N % 16 == 0, G in {32, 64,
// 128}.
extern "C" int tce_int4_matmul_glu(const void* gu, const void* w,
                                   const void* s, int scale_bf16, void* act,
                                   void* part, void* y, int M, int F, int N,
                                   int G, int sb_per_band, int bands,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t threads = (size_t)M * F / 8;
  glu_act_kernel<<<(unsigned)((threads + ACT_THREADS - 1) / ACT_THREADS),
                   ACT_THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(gu), static_cast<__nv_bfloat16*>(act),
      M, F);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  float* p = static_cast<float*>(part);
  const int err =
      scale_bf16 ? tce::mma4::launch_mma<__nv_bfloat16, true>(
                       act, w, s, p, M, F, N, G, sb_per_band, bands, st)
                 : tce::mma4::launch_mma<float, true>(
                       act, w, s, p, M, F, N, G, sb_per_band, bands, st);
  return err ? err : reduce(p, y, M, N, bands, st);
}
