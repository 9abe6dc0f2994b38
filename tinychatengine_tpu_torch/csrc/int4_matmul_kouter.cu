// W4A16 matmul at small M with K walked in bands (the K-outer route), and
// the down projection with silu(gate) * up folded into its prologue.
//
// Replaces: tinychatengine_tpu/ops/int4_matmul.py · _int4_matmul_kouter
// (body _kouter_kernel, pallas_call site :394) and · int4_matmul_glu
// (body _glu_kernel, pallas_call site :849).
//
// K-outer: y[M, N] = x[M, K] @ ((q - 8) * d) over one layer of a stacked
// weight (the wrapper offsets the pointers). The TPU kernel walks a K band's
// weight rows with N innermost, keeps x resident across the band and a
// full-N f32 accumulator in VMEM. Here the band is a grid dimension: one
// block per (128 columns, 8 rows or 1, K band of block_k rows from the
// route's table), each streaming its band's [block_k / 2, 128] slab of the
// K-major packed layout (coalesced along N) and writing f32 band sums; a
// second kernel sums the bands in K order and rounds to bf16 once. M runs
// from 1 (decode) to 496 (prompt buckets) by the grid's row dimension.
//
// GLU: y = bf16(silu(g) * u) @ ((q - 8) * d), g and u the two halves of the
// fused gate_up output gu [M, 2F] (bf16), F columns apart. Each block makes
// its superblock of the activation from g and u as it stages it into
// shared memory (sigmoid in f32, rounded to bf16 as the TPU kernel does), so
// no [M, F] activation goes through device memory; K splits over bands as
// in the fused decode kernel.
//
// Bound on the H100: bytes at decode (the N * K / 2 weight bytes over
// 3.35 TB/s: a weight byte feeds 2 multiply-adds a row); the CUDA cores'
// f32 rate above ~100 rows. Later work: tensor cores (bf16 codes are exact)
// with a TMA-fed pipeline.

#include "int4_band.cuh"

using tce::band::GluRows;
using tce::band::XRows;

// x [M, K] bf16 (K the packed K); w [K/2, N] uint8; s [K/G, N] (bf16 when
// scale_bf16 != 0, else f32); part [bands, M, N] f32 scratch; y [M, N]
// bf16. K splits into bands of sb_per_band superblocks. Needs K % 256 == 0,
// N % 4 == 0, G in {32, 64, 128}.
extern "C" int tce_int4_matmul_kouter(const void* x, const void* w,
                                      const void* s, int scale_bf16,
                                      void* part, void* y, int M, int K, int N,
                                      int G, int sb_per_band, int bands,
                                      void* stream) {
  const XRows src{static_cast<const __nv_bfloat16*>(x), K};
  float* p = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return scale_bf16 ? tce::band::launch_bands<__nv_bfloat16>(
                          src, w, s, p, y, M, K, N, G, sb_per_band, bands, st)
                    : tce::band::launch_bands<float>(src, w, s, p, y, M, K, N,
                                                     G, sb_per_band, bands, st);
}

// gu [M, 2F] bf16; w [F/2, N] uint8; s [F/G, N]; part [bands, M, N] f32;
// y [M, N] bf16. Needs F % 256 == 0, N % 4 == 0, G in {32, 64, 128}.
extern "C" int tce_int4_matmul_glu(const void* gu, const void* w,
                                   const void* s, int scale_bf16, void* part,
                                   void* y, int M, int F, int N, int G,
                                   int sb_per_band, int bands, void* stream) {
  const GluRows<__nv_bfloat16> src{static_cast<const __nv_bfloat16*>(gu), F,
                                   M, 1};
  float* p = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return scale_bf16 ? tce::band::launch_bands<__nv_bfloat16>(
                          src, w, s, p, y, M, F, N, G, sb_per_band, bands, st)
                    : tce::band::launch_bands<float>(src, w, s, p, y, M, F, N,
                                                     G, sb_per_band, bands, st);
}
