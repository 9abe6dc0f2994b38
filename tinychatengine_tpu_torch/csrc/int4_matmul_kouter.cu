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
// fused gate_up output gu [M, 2F] (bf16), F columns apart. Each block makes
// its superblock of the activation from g and u as it stages it into
// shared memory (sigmoid in f32, rounded to bf16 as the TPU kernel does), so
// no [M, F] activation goes through device memory; K splits over bands as
// in the fused decode kernel. It keeps the CUDA-core loop.

#include "int4_band.cuh"
#include "int4_mma.cuh"

using tce::band::GluRows;

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
  if (err) return err;
  const int mn = M * N;
  tce::band::reduce_bands<<<(mn + tce::band::THREADS - 1) / tce::band::THREADS,
                            tce::band::THREADS, 0, st>>>(
      p, static_cast<__nv_bfloat16*>(y), mn, bands);
  return (int)cudaGetLastError();
}

// gu [M, 2F] bf16; w [F/2, N] uint8; s [F/G, N]; part [bands, M, N] f32;
// y [M, N] bf16. Needs F % 256 == 0, N % 4 == 0, G in {32, 64, 128}.
extern "C" int tce_int4_matmul_glu(const void* gu, const void* w,
                                   const void* s, int scale_bf16, void* part,
                                   void* y, int M, int F, int N, int G,
                                   int sb_per_band, int bands, void* stream) {
  const GluRows src{static_cast<const __nv_bfloat16*>(gu), F};
  float* p = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return scale_bf16 ? tce::band::launch_bands<__nv_bfloat16>(
                          src, w, s, p, y, M, F, N, G, sb_per_band, bands, st)
                    : tce::band::launch_bands<float>(src, w, s, p, y, M, F, N,
                                                     G, sb_per_band, bands, st);
}
