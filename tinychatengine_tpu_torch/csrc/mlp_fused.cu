// The Llama MLP in one launch: y = bf16(silu(x @ Wg) * (x @ Wu)) @ Wd.
//
// Replaces: tinychatengine_tpu/ops/mlp_fused.py · mlp_fused (body
// _mlp_kernel with _dequant_dot, pallas_call site :176).
//
// The TPU kernel runs two phases over one sequential grid and keeps the
// gate_up product gu [M, 2F] (f32) in VMEM between them. An SM's shared
// memory cannot hold it (1.8 MB at M = 16, F = 14336), but the 50 MB L2 can.
// So this is one cooperative launch of persistent blocks, each walking work
// items of three phases with a grid-wide barrier between them:
//   A. gu band sums: items of (128 columns of 2F, 8 rows or 1, a K band of
//      E), each the int4 band contraction of x (``tce::band``) written as
//      f32 to part_a [bands_a, M, 2F] (L2-resident);
//   B. down band sums: items of (128 columns of E, rows, a K band of F);
//      staging a superblock of the activation sums gate and up over the
//      A bands in K order, applies sigmoid(g) * g * u in f32 and rounds to
//      bf16 (the TPU kernel's act), into shared memory; written as f32 to
//      part_b [bands_b, M, E];
//   C. y = bf16(sum over the B bands in K order).
// gu stays in f32 throughout, as in the TPU kernel. The barrier is
// cooperative_groups' grid sync, which needs every block resident at once:
// the grid is sized from the occupancy API (blocks an SM holds x SMs) and
// launched with cudaLaunchCooperativeKernel, which refuses a grid that
// cannot be co-resident instead of hanging.
//
// Bound on the H100: bytes, the 3 E F / 2 weight bytes of the two weights
// over 3.35 TB/s (M <= 16 rows). Later work: tensor cores, and phase B's
// weight loads issued before the barrier.

#include <cooperative_groups.h>

#include <algorithm>

#include "int4_band.cuh"

namespace cg = cooperative_groups;

namespace {

using tce::band::COLS;
using tce::band::SB;
using tce::band::THREADS;

struct MlpArgs {
  const __nv_bfloat16* x;
  const uint8_t *wa, *wb;
  const void *sa, *sb;
  float *part_a, *part_b;
  __nv_bfloat16* y;
  int M, E, F, G, per_a, bands_a, per_b, bands_b;
};

template <typename ST, int MT>
__global__ void __launch_bounds__(THREADS) mlp_kernel(MlpArgs a) {
  __shared__ tce::band::Smem<MT> sm;
  cg::grid_group grid = cg::this_grid();
  const int mtiles = (a.M + MT - 1) / MT;

  // A: gu = x @ W_gate_up, f32 band sums
  const int tiles_a = 2 * a.F / COLS, nsb_a = a.E / SB;
  const int items_a = tiles_a * mtiles * a.bands_a;
  const tce::band::XRows xsrc{a.x, a.E};
  for (int it = blockIdx.x; it < items_a; it += gridDim.x) {
    const int nt = it % tiles_a, mt = (it / tiles_a) % mtiles,
              band = it / (tiles_a * mtiles);
    const int sb0 = band * a.per_a;
    tce::band::band_partial<ST, MT>(
        xsrc, a.wa, static_cast<const ST*>(a.sa), a.part_a, a.M, 2 * a.F, a.G,
        mt * MT, nt, sb0, min(sb0 + a.per_a, nsb_a), band, sm);
  }
  __threadfence();
  grid.sync();

  // B: y bands = bf16(silu(gate) * up) @ W_down
  const int tiles_b = a.E / COLS, nsb_b = a.F / SB;
  const int items_b = tiles_b * mtiles * a.bands_b;
  const tce::band::GluRows<float> gsrc{a.part_a, a.F, a.M, a.bands_a};
  for (int it = blockIdx.x; it < items_b; it += gridDim.x) {
    const int nt = it % tiles_b, mt = (it / tiles_b) % mtiles,
              band = it / (tiles_b * mtiles);
    const int sb0 = band * a.per_b;
    tce::band::band_partial<ST, MT>(
        gsrc, a.wb, static_cast<const ST*>(a.sb), a.part_b, a.M, a.E, a.G,
        mt * MT, nt, sb0, min(sb0 + a.per_b, nsb_b), band, sm);
  }
  __threadfence();
  grid.sync();

  // C: the down bands summed in K order, rounded once
  const int mn = a.M * a.E;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < mn;
       i += gridDim.x * THREADS) {
    float v = 0.f;
    for (int z = 0; z < a.bands_b; ++z)
      v += tce::band::load_l2(a.part_b + (size_t)z * mn + i);
    a.y[i] = __float2bfloat16(v);
  }
}

template <typename ST, int MT>
int launch(MlpArgs a, cudaStream_t st) {
  auto* kernel = mlp_kernel<ST, MT>;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  if (!coop || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int mtiles = (a.M + MT - 1) / MT;
  const int items = std::max(2 * a.F / COLS * mtiles * a.bands_a,
                             a.E / COLS * mtiles * a.bands_b);
  const int blocks = std::min(items, per_sm * sms);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(blocks), dim3(THREADS), params, 0,
                                    st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, E] bf16; wa [E/2, 2F] and wb [F/2, E] uint8 (one layer each); sa
// [E/G, 2F] and sb [F/G, E], both bf16 when scale_bf16 != 0, else f32;
// part_a [bands_a, M, 2F] and part_b [bands_b, M, E] f32 scratch; y [M, E]
// bf16. E's K splits into bands_a bands of per_a superblocks, F's into
// bands_b of per_b. Needs E, F % 256 == 0, E, 2F % 128 == 0, G in
// {32, 64, 128}. Returns a CUDA error code (cudaErrorCooperativeLaunchTooLarge
// where the card cannot hold one block per SM or launch cooperatively).
extern "C" int tce_mlp_fused(const void* x, const void* wa, const void* sa,
                             const void* wb, const void* sb, int scale_bf16,
                             void* part_a, void* part_b, void* y, int M, int E,
                             int F, int G, int per_a, int bands_a, int per_b,
                             int bands_b, void* stream) {
  const MlpArgs a{static_cast<const __nv_bfloat16*>(x),
                  static_cast<const uint8_t*>(wa),
                  static_cast<const uint8_t*>(wb),
                  sa, sb,
                  static_cast<float*>(part_a), static_cast<float*>(part_b),
                  static_cast<__nv_bfloat16*>(y),
                  M, E, F, G, per_a, bands_a, per_b, bands_b};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M == 1)
    return scale_bf16 ? launch<__nv_bfloat16, 1>(a, st) : launch<float, 1>(a, st);
  return scale_bf16 ? launch<__nv_bfloat16, 8>(a, st) : launch<float, 8>(a, st);
}
