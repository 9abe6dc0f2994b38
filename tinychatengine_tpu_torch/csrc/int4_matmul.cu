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
// Two routes; the wrapper's ``int4_route`` picks one from M alone and
// passes it as ``bands`` (negative for the tile route: minus its token
// tile):
//
// M <= 8, the band route: memory-bound (the N * K / 2 weight bytes over
// 3.35 TB/s; a weight byte feeds at most 16 multiply-adds). The split-K
// band contraction of csrc/int4_band.cuh on the CUDA cores: one block per
// (128 columns, the rows, a band of whole superblocks), f32 band sums
// added in K order by a second kernel. The wrapper picks the
// band from K and N (never from M) so that at least two blocks per SM
// stream the weight; an unstacked weight (the lm_head, [2048, 129024]
// bytes) is one layer at offset 0. The TPU kernel's cast point: the exact
// codes, times the f32 scale once per 16 rows.
//
// M >= 9, the tile route: wgmma with the weights as the register-fed A
// operand. The product is computed transposed, y^T = W^T x^T: a block owns
// 128 weight columns, two consumer warpgroups of 64 (wgmma's m64), and a
// token tile of T rows of x as wgmma's n (T = 16, 32, 64, 128 or 256, the
// smallest that holds M, 256-row tiles above; the wrapper's
// ``tile_width`` chooses it and passes it, so the launch counter and the
// launch read one choice), so a 16-row decode tick computes 16 rows, not
// 128, and a 512-row chunk dequantizes each weight once per 256 rows.
// Each consumer thread dequantizes its packed bytes from shared memory
// straight into wgmma.mma_async m64nTk16's A fragments (rows 16 w + g and
// + 8 of a warpgroup are the adjacent columns 2 g and 2 g + 1 of the
// warp's 16, so a thread reads two bytes of each of its four packed rows
// of a k16 step, and each byte feeds both nibble planes); x's rows are the
// B operand, K-major from shared memory. One producer warp keeps a ring
// of stages in flight, each 64 packed rows (k: 64 low, 64 high) of the
// block's 128 columns, the stage's scale rows and x's two [T][64] tiles,
// all by TMA (128-byte swizzle for the weights and x, so a warp's loads
// hit 32 distinct banks; rows past M and columns past N zero-filled) on one
// mbarrier; where N % 16 != 0 (a row stride TMA cannot take) the weights
// and scales come by 4-byte cp.async into the same layout. The consumers
// only wait, dequantize and issue wgmma, one k16 step of both planes (8
// A registers) at a time, double-buffered so the tensor cores run step j
// while the CUDA cores dequantize step j + 1 (the A registers are fenced
// before each wgmma.fence, else ptxas serializes every product, C7513);
// no barrier spans the two warpgroups inside a stage (each warp gives its
// slot back once its products of the slot are done). The ring is as deep
// as fits: 7 stages at T = 16, two blocks an SM up to T = 64, one above.
// setmaxnreg gives the consumers 232 registers (104 at two blocks an SM)
// for the 128 accumulators of a 256-row tile.
//
// To fill the card at decode widths (StarCoder's c_proj, fc_out and
// c_attn have 48-50 column tiles) K is split over a power of two, up to 8,
// of blocks of one cluster (the wrapper's ``tile_split``: from K and N
// alone, never from M, so it applies at every M of the route: 4 at those
// three, which a 512-row chunk pays for; none at fc_in and the lm_head);
// each block leaves its f32 sums in its shared memory and, after a
// cluster barrier, sums a share of the tile over the cluster's blocks in
// K order (distributed shared memory) and rounds to bf16, in one launch
// with no scratch in device memory.
//
// Cast point, the plain version's (int4_matmul_xla): A = bf16((q - 8) * d)
// with f32 sums. With bf16 scales, 128 + q is built as a bf16 by a mask
// and an or, q - 8 is exact in bf16 and its product with the scale exact
// in f32, so one bf16x2 fma (the subtraction) and one bf16x2 multiply
// give exactly bf16((q - 8) * d); with f32 scales the product is taken
// in f32 and rounded once, as before.
//
// Bounds on the H100: at 16 rows the weight and scale bytes over 3.35
// TB/s (StarCoder's fc_out, 77.9 MB: 0.0232 ms); dequantization costs
// about four instructions per A register (two weights), which 16
// consumer warps an SM issue at about twice the byte rate, but each k16
// step waits for the previous step's products, and at 16 rows that
// latency, not the issue rate, holds the kernel: fc_out runs 0.0545 ms
// where the ring alone streams its bytes in 0.045 (PERF.md). At 512 rows
// the operations (2 M N K over 989 TFLOP/s; gate_up 0.122 ms): per stage
// a 256-row tile runs 8 m64n256k16 products a warpgroup against ~150
// instructions of dequantization, and x streams from L2 at ~32 bytes a
// cycle an SM; gate_up runs 0.21 ms.
//
// Determinism, within a route only: an output row's bits depend on its x
// row (and the weights) alone, not on M, on the tile the row falls in or on
// the other rows: rows never mix in wgmma (a row is a column of B), the
// dequantized weights and the k order do not depend on T, and the K split
// depends on K and N only, its band sums added in K order; the band
// route's partition depends on K and N only. The two routes compute
// at different cast points, so a row's bits change where M crosses from 8
// to 9. The chunked prefills that must give the same tokens with and
// without a prefix-cache hit rely on this within a route; a hit whose
// uncached tail is 8 rows or fewer, against a chunk of 9 or more, is not
// covered.

#include "int4_band.cuh"
#include "int4_tile.cuh"

namespace cg = cooperative_groups;

namespace {

// one (K split, T rows, 128 columns) item of a [split, M/T, N/128] grid; a
// tile's K splits form one cluster
template <int T, typename ST>
__global__ void __launch_bounds__(THREADS, Cfg<T>::MIN_BLOCKS) tile_kernel(
    const __grid_constant__ Maps maps, const uint8_t* __restrict__ w,
    const ST* __restrict__ s, __nv_bfloat16* __restrict__ y, int M, int K,
    int N, int G, int tma) {
  constexpr int STAGES = Cfg<T>::STAGES;
  static_assert(T * PSTRIDE * 4 <= STAGES * (int)sizeof(Slot<T>),
                "the block's sums overlay the ring");
  extern __shared__ uint8_t smem_raw[];
  Ring<T>& rg = *reinterpret_cast<Ring<T>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  cg::cluster_group cluster = cg::this_cluster();
  const int split = gridDim.x, rank = (int)cluster.block_rank();
  const int m0 = blockIdx.y * T, n0 = blockIdx.z * BN;
  const int n_st = K / 128;  // stages of K
  const int st0 = rank * n_st / split;
  const int count = (rank + 1) * n_st / split - st0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      // the TMA's arrival (+ 32 lanes' copies without TMA for the weights)
      mbar_init(&rg.full[i], tma ? 1 : 33);
      mbar_init(&rg.empty[i], CONSUMERS / 32);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the roles split here and never rejoin (setmaxnreg's rule): each ends
  // with the two cluster barriers around the reduction
  float* part = reinterpret_cast<float*>(&rg);  // [T][PSTRIDE] over the ring
  if (threadIdx.x >= CONSUMERS) {
    setmaxnreg_dec<Cfg<T>::PRODUCER_REGS>();
    if (threadIdx.x / 32 == CONSUMERS / 32)
      produce<T, ST>(rg, maps, w, s, N, G, m0, n0, st0, count, tma != 0);
    cluster.sync();
    cluster.sync();
  } else {
    setmaxnreg_inc<Cfg<T>::CONSUMER_REGS>();
    float acc[T / 2];
#pragma unroll
    for (int e = 0; e < T / 2; ++e) acc[e] = 0.f;
    consume<T, ST>(rg, acc, G, count);
    named_sync(1, CONSUMERS);  // both warpgroups are done with the ring
    // thread (warp, g, t) holds tile rows 8 c + 2t (+ 1) of columns cl
    // (acc[4c], acc[4c + 1]) and cl + 1 (acc[4c + 2], acc[4c + 3])
    const int lane = threadIdx.x % 32;
    const int cl = 64 * (threadIdx.x / 128) + 16 * ((threadIdx.x / 32) % 4) +
                   2 * (lane / 4);
#pragma unroll
    for (int c = 0; c < T / 8; ++c) {
      const int r = 8 * c + 2 * (lane % 4);
      *reinterpret_cast<float2*>(part + r * PSTRIDE + cl) =
          make_float2(acc[4 * c], acc[4 * c + 2]);
      *reinterpret_cast<float2*>(part + (r + 1) * PSTRIDE + cl) =
          make_float2(acc[4 * c + 1], acc[4 * c + 3]);
    }
    cluster.sync();  // every split's sums are in its shared memory
    // block `rank` sums every split-th float4 of the tile over the splits
    // in K order and rounds it to bf16
    for (int i = rank * CONSUMERS + threadIdx.x; i < T * (BN / 4);
         i += split * CONSUMERS) {
      const int r = i / (BN / 4), c = 4 * (i % (BN / 4));
      const int m = m0 + r, n = n0 + c;
      if (m >= M || n >= N) continue;
      float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, 0) + r * PSTRIDE + c);
      for (int z = 1; z < split; ++z) {
        const float4 u = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part, z) + r * PSTRIDE + c);
        v.x = __fadd_rn(v.x, u.x);
        v.y = __fadd_rn(v.y, u.y);
        v.z = __fadd_rn(v.z, u.z);
        v.w = __fadd_rn(v.w, u.w);
      }
      store_bf16x4(y + (size_t)m * N + n, v);
    }
    cluster.sync();  // no block leaves while another reads its sums
  }
}

template <int T, typename ST>
int launch_tile_t(const void* x, const void* w, const void* s, void* y, int M,
                  int K, int N, int G, int split, cudaStream_t st) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  // TMA reads rows whose stride and base are multiples of 16 bytes
  const int tma = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(s) % 16 == 0;
  Maps maps = {};
  if (!encode_2d(encode, &maps.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M,
                 (uint64_t)K * 2, 64, T, CU_TENSOR_MAP_SWIZZLE_128B) ||
      (tma && !encode_2d(encode, &maps.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N,
                         K / 2, N, BN, ROWS, CU_TENSOR_MAP_SWIZZLE_128B)) ||
      (tma && !encode_2d(encode, &maps.s,
                         sizeof(ST) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                         s, N, K / G, (uint64_t)N * sizeof(ST), BN,
                         G == 32 ? 2 : 1, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return (int)cudaErrorInvalidValue;
  auto kernel = tile_kernel<T, ST>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T>());
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  // the splits of a tile fastest, then the row tiles: the blocks in flight
  // share a few weight tiles in L2
  cfg.gridDim = dim3(split, (M + T - 1) / T, (N + BN - 1) / BN);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes<T>();
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, maps, static_cast<const uint8_t*>(w),
      static_cast<const ST*>(s), static_cast<__nv_bfloat16*>(y), M, K, N, G,
      tma);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// T: the token-tile width the wrapper chose (``tile_width``)
template <typename ST>
int launch_tile(const void* x, const void* w, const void* s, void* y, int M,
                int K, int N, int G, int split, int T, cudaStream_t st) {
  switch (T) {
    case 16:
      return launch_tile_t<16, ST>(x, w, s, y, M, K, N, G, split, st);
    case 32:
      return launch_tile_t<32, ST>(x, w, s, y, M, K, N, G, split, st);
    case 64:
      return launch_tile_t<64, ST>(x, w, s, y, M, K, N, G, split, st);
    case 128:
      return launch_tile_t<128, ST>(x, w, s, y, M, K, N, G, split, st);
    case 256:
      return launch_tile_t<256, ST>(x, w, s, y, M, K, N, G, split, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x [M, K] bf16, 16-byte aligned (K already padded to the packed K); w
// [K/2, N] uint8, 4-byte aligned; s [K/G, N] (bf16 when scale_bf16 != 0,
// 8-byte aligned, else f32, 16-byte aligned); y [M, N] bf16. bands > 0
// takes the band route: part is f32 scratch of bands * M * N, K split into
// bands of sb_per_band superblocks; bands < 0 the tile route (part
// unused) at a token tile of -bands rows (16, 32, 64, 128 or 256), K split
// over sb_per_band blocks of one cluster (1 to 8, at most K / 128). Needs
// K % 256 == 0, N % 4 == 0, G in {32, 64, 128}.
extern "C" int tce_int4_matmul(const void* x, const void* w, const void* s,
                               void* y, int M, int K, int N, int G,
                               int scale_bf16, void* part, int sb_per_band,
                               int bands, void* stream) {
  if (M < 1 || K % 256 || N % 4 || (G != 32 && G != 64 && G != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bands > 0) {
    float* p = static_cast<float*>(part);
    return scale_bf16
               ? tce::band::launch_bands<__nv_bfloat16>(
                     x, w, s, p, y, M, K, N, G, sb_per_band, bands, st)
               : tce::band::launch_bands<float>(x, w, s, p, y, M, K, N, G,
                                                sb_per_band, bands, st);
  }
  const int split = sb_per_band, T = -bands;
  if (split < 1 || split > MAX_SPLIT || split > K / 128 ||
      reinterpret_cast<uintptr_t>(w) % 4 ||
      reinterpret_cast<uintptr_t>(s) % (scale_bf16 ? 8 : 16))
    return (int)cudaErrorInvalidValue;
  return scale_bf16
             ? launch_tile<__nv_bfloat16>(x, w, s, y, M, K, N, G, split, T,
                                          st)
             : launch_tile<float>(x, w, s, y, M, K, N, G, split, T, st);
}
