// The Llama MLP in one launch: y = bf16(silu(x @ Wg) * (x @ Wu)) @ Wd.
//
// Replaces: tinychatengine_tpu/ops/mlp_fused.py · mlp_fused (body
// _mlp_kernel with _dequant_dot, pallas_call site :176).
//
// The TPU kernel runs two phases over one sequential grid and keeps the
// gate_up product gu [M, 2F] (f32) in VMEM between them. An SM's shared
// memory cannot hold it (1.8 MB at M = 16, F = 14336), but the 50 MB L2 can.
// So this is one cooperative launch of persistent blocks, each walking work
// items of four phases with a grid-wide barrier between them:
//   A. gu band sums: items of (128 columns of 2F, the row tile, a K band of
//      E), each the tensor-core contraction of csrc/int4_mma.cuh
//      (``band_item``: exact codes q - 8 in bf16 by mma.sync m16n8k16 into
//      a per-group f32 sum folded with its f32 scale by fma, groups in K
//      order) written as f32 to part_a [bands_a, M, 2F] (L2-resident);
//   A2. act [M, F] = bf16(sigmoid(g) * g * u), g and u summed over the A
//      bands in K order in f32 (the TPU kernel's act), into a bf16 scratch;
//   B. down band sums: the same contraction with act as its x rows,
//      written as f32 to part_b [bands_b, M, E];
//   C. y = bf16(sum over the B bands in K order).
// gu stays in f32 throughout and act is rounded to bf16 once, as in the
// TPU kernel. Each block requests the weights and scales of its first B
// item's first superblock before the barrier that ends phase A, so they
// arrive while the act is made. The barrier is cooperative_groups' grid
// sync, which needs every block resident at once: the grid is sized from
// the occupancy API at the kernel's shared-memory size (blocks an SM holds
// x SMs) and launched with cudaLaunchCooperativeKernel, which refuses a
// grid that cannot be co-resident instead of hanging.
//
// Bound on the H100: bytes, the 3 E F / 2 weight bytes of the two weights
// over 3.35 TB/s (M <= 16 rows; 0.027 ms at llama3_8b's widths). The
// CUDA-core band loop this replaced (one f32 FMA per code per row) took
// 0.47 ms at M = 16.

#include <cooperative_groups.h>

#include <algorithm>

#include "int4_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;
constexpr int COLS = 128;  // columns per work item
constexpr int SB = 256;    // K rows per superblock

struct MlpArgs {
  const __nv_bfloat16* x;
  const uint8_t *wa, *wb;
  const void *sa, *sb;
  float *part_a, *part_b;
  __nv_bfloat16 *act, *y;
  int M, E, F, per_a, bands_a, per_b, bands_b;
};

// item ``it`` of a phase: (column tile, row tile, band) with column tiles
// fastest
struct Item {
  int n0, m0, sb0, count, band;
};

__device__ __forceinline__ Item item_of(int it, int tiles, int mtiles, int mt,
                                        int per, int nsb) {
  Item r;
  r.n0 = (it % tiles) * COLS;
  r.m0 = ((it / tiles) % mtiles) * mt;
  r.band = it / (tiles * mtiles);
  r.sb0 = r.band * per;
  r.count = min(per, nsb - r.sb0);
  return r;
}

template <typename ST, int G, int NT>
__global__ void __launch_bounds__(THREADS) mlp_kernel(MlpArgs a) {
  using C = tce::mma4::Cfg<NT>;
  extern __shared__ __align__(16) uint8_t smem[];
  cg::grid_group grid = cg::this_grid();
  const int mtiles = (a.M + C::MT - 1) / C::MT;
  const ST* sa = static_cast<const ST*>(a.sa);
  const ST* sb = static_cast<const ST*>(a.sb);

  // A: gu = x @ W_gate_up, f32 band sums
  const int tiles_a = 2 * a.F / COLS, nsb_a = a.E / SB;
  const int items_a = tiles_a * mtiles * a.bands_a;
  for (int it = blockIdx.x; it < items_a; it += gridDim.x) {
    const Item w = item_of(it, tiles_a, mtiles, C::MT, a.per_a, nsb_a);
    tce::mma4::band_item<ST, G, NT>(a.x, a.wa, sa, a.part_a, a.M, a.E,
                                    2 * a.F, w.m0, w.n0, w.sb0, w.count,
                                    w.band, smem);
    __syncthreads();  // the ring is free for the next item
  }

  // the first B item's first weights, requested before the barrier
  const int tiles_b = a.E / COLS, nsb_b = a.F / SB;
  const int items_b = tiles_b * mtiles * a.bands_b;
  const bool staged = blockIdx.x < items_b;
  if (staged) {
    const Item w = item_of(blockIdx.x, tiles_b, mtiles, C::MT, a.per_b, nsb_b);
    tce::mma4::load_weights<ST, G, C>(smem, a.wb, sb, a.E, w.n0, w.sb0);
  }
  tce::mma4::cp_async_commit();
  __threadfence();
  grid.sync();

  // A2: act = bf16(silu(gate) * up) from the A bands summed in K order;
  // sigmoid(g) = 1 / (1 + exp(-g)), no contraction into FMAs
  const int mf = a.M * a.F;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < mf;
       i += gridDim.x * THREADS) {
    const int m = i / a.F, k = i % a.F;
    float g = 0.f, u = 0.f;
    for (int z = 0; z < a.bands_a; ++z) {
      const float* row = a.part_a + ((size_t)z * a.M + m) * 2 * a.F;
      g = __fadd_rn(g, __ldcg(row + k));
      u = __fadd_rn(u, __ldcg(row + a.F + k));
    }
    const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g)));
    a.act[i] = __float2bfloat16(__fmul_rn(__fmul_rn(sig, g), u));
  }
  __threadfence();
  grid.sync();

  // B: y bands = act @ W_down
  for (int it = blockIdx.x; it < items_b; it += gridDim.x) {
    const Item w = item_of(it, tiles_b, mtiles, C::MT, a.per_b, nsb_b);
    tce::mma4::band_item<ST, G, NT>(a.act, a.wb, sb, a.part_b, a.M, a.F, a.E,
                                    w.m0, w.n0, w.sb0, w.count, w.band, smem,
                                    staged && it == (int)blockIdx.x);
    __syncthreads();
  }
  __threadfence();
  grid.sync();

  // C: the down bands summed in K order, rounded once
  const int mn = a.M * a.E;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < mn;
       i += gridDim.x * THREADS) {
    float v = 0.f;
    for (int z = 0; z < a.bands_b; ++z)
      v += __ldcg(a.part_b + (size_t)z * mn + i);
    a.y[i] = __float2bfloat16(v);
  }
}

template <typename ST, int G, int NT>
int launch(MlpArgs a, cudaStream_t st) {
  using C = tce::mma4::Cfg<NT>;
  auto* kernel = mlp_kernel<ST, G, NT>;
  static bool configured = false;  // once, outside any CUDA graph capture
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  if (!coop || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int mtiles = (a.M + C::MT - 1) / C::MT;
  const int items = std::max(2 * a.F / COLS * mtiles * a.bands_a,
                             a.E / COLS * mtiles * a.bands_b);
  const int blocks = std::min(items, per_sm * sms);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(blocks), dim3(THREADS), params,
                                    C::SMEM, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename ST, int G>
int launch_g(const MlpArgs& a, cudaStream_t st) {
  return tce::mma4::row_tile(a.M) == 8 ? launch<ST, G, 1>(a, st)
                                       : launch<ST, G, 2>(a, st);
}

template <typename ST>
int launch_st(const MlpArgs& a, int G, cudaStream_t st) {
  switch (G) {
    case 32:
      return launch_g<ST, 32>(a, st);
    case 64:
      return launch_g<ST, 64>(a, st);
    default:
      return launch_g<ST, 128>(a, st);
  }
}

}  // namespace

// x [M, E] bf16; wa [E/2, 2F] and wb [F/2, E] uint8 (one layer each); sa
// [E/G, 2F] and sb [F/G, E], both bf16 when scale_bf16 != 0, else f32; x,
// the weights and the scales 16-byte aligned; part_a [bands_a, M, 2F] and
// part_b [bands_b, M, E] f32 scratch, act [M, F] bf16 scratch; y [M, E]
// bf16. E's K splits into bands_a bands of per_a superblocks, F's into
// bands_b of per_b. Needs M <= 16, E, F % 256 == 0, G in {32, 64, 128}.
// Returns a CUDA error code (cudaErrorCooperativeLaunchTooLarge where the
// card cannot hold one block per SM or launch cooperatively).
extern "C" int tce_mlp_fused(const void* x, const void* wa, const void* sa,
                             const void* wb, const void* sb, int scale_bf16,
                             void* part_a, void* part_b, void* act, void* y,
                             int M, int E, int F, int G, int per_a,
                             int bands_a, int per_b, int bands_b,
                             void* stream) {
  if (M < 1 || M > 16) return (int)cudaErrorInvalidValue;
  const MlpArgs a{static_cast<const __nv_bfloat16*>(x),
                  static_cast<const uint8_t*>(wa),
                  static_cast<const uint8_t*>(wb),
                  sa, sb,
                  static_cast<float*>(part_a), static_cast<float*>(part_b),
                  static_cast<__nv_bfloat16*>(act),
                  static_cast<__nv_bfloat16*>(y),
                  M, E, F, per_a, bands_a, per_b, bands_b};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return scale_bf16 ? launch_st<__nv_bfloat16>(a, G, st)
                    : launch_st<float>(a, G, st);
}
