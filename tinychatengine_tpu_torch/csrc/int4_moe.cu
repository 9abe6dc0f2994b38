// The sparse-expert layer's kernels (models/moe.py): the router's top-k,
// the plan that sorts the routed (row, expert) pairs by expert, the
// grouped W4A16 expert matmul, SiLU(gate) * up, and the weighted combine.
//
// Replaces no TPU kernel: the JAX package has no expert layer. Added for
// sparse-expert models (Mellum2-12B-A2.5B: 64 experts of width 896 a layer,
// 8 routed a token) so one launch per projection and layer computes every
// expert's rows, with no host sync, and the decode tick still captures.
//
// route_kernel: one warp a row of f32 router logits [n, E] (E <= 256):
// softmax in f32 (exp(l - max) / sum), then k rounds of a warp argmax
// (ties to the lower expert), the chosen probabilities renormalised by
// their sum in choice order when ``norm`` is set. ids [n, k] int32, weights
// [n, k] f32.
//
// plan_kernel: one block over the n * k pairs (pair p = row * k + j) in
// chunks of the block: each pair's rank among the pairs of its expert
// before it (warp peers by __match_any_sync, warps in order through shared
// memory), the experts' counts, their exclusive scan (``offsets`` [E + 1]:
// the sorted slots of expert e are offsets[e] .. offsets[e + 1]), the
// token tiles of T rows each expert needs (``tiles`` [E + 1], a scan), then
// each pair's slot offsets[e] + rank (``slot_of`` [n k]) and the row each
// slot reads (``src`` [n k]). Integer arithmetic only: the order is the
// pairs' own, whatever the block's timing. It adds (experts with a row,
// pairs) to ``stats`` [2] int64, the counters the serving path copies with
// its token fetches.
//
// grouped_kernel: the int4 tile route (csrc/int4_matmul.cu's tile_kernel
// and its pieces in int4_tile.cuh: TMA ring, producer warp, consumer
// warpgroups dequantizing bf16((q - 8) * d) into wgmma's register A
// operand, f32 sums) over a [1, tiles bound, N / 128] grid. Block y finds
// its expert by a binary search of ``tiles`` and computes T sorted rows of
// it from offsets[e] + T (y - tiles[e]); blocks past tiles[E] leave at
// once, so an expert with no rows reads no weight bytes. The weights of
// every (layer, expert) are one stack [L E, K/2, N] (scales [L E, K/G, N])
// and the expert's are read at row (e0 + e) K/2 of its tensor map, as a
// layer of the dense linears is a pointer offset. K is never split (the
// experts fill the card), so a row's sums run in K order and round once:
// its bits depend on its own x row alone, not on T or on the rows beside
// it. Rows of the tile past the expert's last belong to the next expert or
// lie past the pairs (TMA zero-fills them); they are computed and not
// stored. Bound on the H100: at a 32-row decode tick (256 pairs) ~63 of 64
// experts are read, their weight bytes over 3.35 TB/s; at a 512-row chunk
// (~64 rows an expert) the ridge: 2 M N K over 989 TFLOP/s is about the
// bytes' time.
//
// act_kernel: gu [P, 2F] bf16 (gate | up) -> act [P, Fp] bf16,
// bf16(silu(g) * u) in f32 with silu(g) = g / (1 + exp(-g)), the columns
// F .. Fp zero (the down projection's pack-padded K).
//
// combine_kernel: out[t] = bf16(x[t] + bf16(sum_j w[t, j] y[slot[t, j]]))
// with the sum in f32 in j order, each product and add rounded apart (no
// contraction), no atomics: a row's bits depend on its own pairs alone.

#include "int4_tile.cuh"

namespace tce {
namespace moe {

constexpr int ROUTE_MAX_E = 256;   // experts a router row may have
constexpr int PLAN_THREADS = 1024;

__global__ void route_kernel(const float* __restrict__ logits, int n, int E,
                             int k, int norm, int* __restrict__ ids,
                             float* __restrict__ wts) {
  constexpr int PER = ROUTE_MAX_E / 32;
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;
  const float* l = logits + (size_t)row * E;
  float v[PER];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = lane + 32 * i;
    v[i] = e < E ? l[e] : -INFINITY;
    mx = fmaxf(mx, v[i]);
  }
  mx = warp_max(mx);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    v[i] = lane + 32 * i < E ? expf(v[i] - mx) : -1.f;
    if (v[i] > 0.f) sum += v[i];
  }
  sum = warp_sum(sum);
#pragma unroll
  for (int i = 0; i < PER; ++i)
    if (v[i] >= 0.f) v[i] = __fdiv_rn(v[i], sum);
  float chosen = 0.f, total = 0.f;
  int chosen_e = 0;
  for (int j = 0; j < k; ++j) {
    float best = -2.f;
    int be = E;
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (v[i] > best) {
        best = v[i];
        be = lane + 32 * i;
      }
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oe = __shfl_xor_sync(0xffffffffu, be, o);
      if (ob > best || (ob == best && oe < be)) {
        best = ob;
        be = oe;
      }
    }
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (lane + 32 * i == be) v[i] = -2.f;  // taken
    total = __fadd_rn(total, best);
    if (lane == j) {
      chosen = best;
      chosen_e = be;
    }
  }
  if (lane < k) {
    ids[(size_t)row * k + lane] = chosen_e;
    wts[(size_t)row * k + lane] = norm ? __fdiv_rn(chosen, total) : chosen;
  }
}

__global__ void __launch_bounds__(PLAN_THREADS)
    plan_kernel(const int* __restrict__ ids, int P, int E, int k, int T,
                int* __restrict__ src, int* __restrict__ slot_of,
                int* __restrict__ offsets, int* __restrict__ tiles,
                long long* __restrict__ stats) {
  extern __shared__ int sh[];
  int* base = sh;       // [E]: pairs of each expert before the chunk
  int* wc = sh + E;     // [32 warps][E]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int e = tid; e < E; e += PLAN_THREADS) base[e] = 0;
  for (int c0 = 0; c0 < P; c0 += PLAN_THREADS) {
    for (int i = tid; i < 32 * E; i += PLAN_THREADS) wc[i] = 0;
    __syncthreads();
    const int p = c0 + tid;
    const int e = p < P ? ids[p] : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, e);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (e >= 0 && rank == 0) wc[warp * E + e] = __popc(peers);
    __syncthreads();
    for (int x = tid; x < E; x += PLAN_THREADS) {
      int s = base[x];
      for (int w = 0; w < 32; ++w) {
        const int c = wc[w * E + x];
        wc[w * E + x] = s;
        s += c;
      }
      base[x] = s;
    }
    __syncthreads();
    if (e >= 0) slot_of[p] = wc[warp * E + e] + rank;
    __syncthreads();
  }
  if (tid == 0) {
    int off = 0, tl = 0, used = 0;
    for (int e = 0; e < E; ++e) {
      const int c = base[e];
      offsets[e] = off;
      tiles[e] = tl;
      base[e] = off;
      off += c;
      tl += (c + T - 1) / T;
      used += c > 0;
    }
    offsets[E] = off;
    tiles[E] = tl;
    stats[0] += used;
    stats[1] += P;
  }
  __syncthreads();
  for (int p = tid; p < P; p += PLAN_THREADS) {
    const int s = base[ids[p]] + slot_of[p];
    slot_of[p] = s;
    src[s] = p / k;
  }
}

template <int T, typename ST>
__global__ void __launch_bounds__(THREADS, Cfg<T>::MIN_BLOCKS) grouped_kernel(
    const __grid_constant__ Maps maps, const uint8_t* __restrict__ w,
    const ST* __restrict__ s, __nv_bfloat16* __restrict__ y,
    const int* __restrict__ offsets, const int* __restrict__ tiles, int E,
    int e0, int K, int N, int G) {
  constexpr int STAGES = Cfg<T>::STAGES;
  const int tile = blockIdx.y;
  if (tile >= tiles[E]) return;  // past the routed rows' tiles
  int lo = 0, hi = E;            // tiles[lo] <= tile < tiles[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (tiles[mid] <= tile) lo = mid;
    else hi = mid;
  }
  const int m0 = offsets[lo] + (tile - tiles[lo]) * T;
  const int m_end = offsets[lo + 1];
  const int n0 = blockIdx.z * BN;
  extern __shared__ uint8_t smem_raw[];
  Ring<T>& rg = *reinterpret_cast<Ring<T>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int n_st = K / 128;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&rg.full[i], 1);
      mbar_init(&rg.empty[i], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= CONSUMERS) {
    setmaxnreg_dec<Cfg<T>::PRODUCER_REGS>();
    if (threadIdx.x / 32 == CONSUMERS / 32)
      produce<T, ST>(rg, maps, w, s, N, G, m0, n0, 0, n_st, true,
                     (e0 + lo) * (K / 2), (e0 + lo) * (K / G));
    return;
  }
  setmaxnreg_inc<Cfg<T>::CONSUMER_REGS>();
  float acc[T / 2];
#pragma unroll
  for (int e = 0; e < T / 2; ++e) acc[e] = 0.f;
  consume<T, ST>(rg, acc, G, n_st);
  // thread (warp, g, t) holds tile rows 8 c + 2t (+ 1) of columns cl
  // (acc[4c], acc[4c + 1]) and cl + 1 (acc[4c + 2], acc[4c + 3])
  const int lane = threadIdx.x % 32;
  const int n = n0 + 64 * (threadIdx.x / 128) +
                16 * ((threadIdx.x / 32) % 4) + 2 * (lane / 4);
  if (n >= N) return;
#pragma unroll
  for (int c = 0; c < T / 8; ++c) {
    const int m = m0 + 8 * c + 2 * (lane % 4);
    if (m < m_end)
      *reinterpret_cast<__nv_bfloat162*>(y + (size_t)m * N + n) =
          __floats2bfloat162_rn(acc[4 * c], acc[4 * c + 2]);
    if (m + 1 < m_end)
      *reinterpret_cast<__nv_bfloat162*>(y + (size_t)(m + 1) * N + n) =
          __floats2bfloat162_rn(acc[4 * c + 1], acc[4 * c + 3]);
  }
}

template <int T, typename ST>
int launch_grouped_t(const void* x, const void* w, const void* s, void* y,
                     const int* offsets, const int* tiles, int P, int E,
                     int e0, int n_sets, int K, int N, int G, int grid_tiles,
                     cudaStream_t st) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  Maps maps = {};
  if (!encode_2d(encode, &maps.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, P,
                 (uint64_t)K * 2, 64, T, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(encode, &maps.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N,
                 (uint64_t)n_sets * (K / 2), N, BN, ROWS,
                 CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(encode, &maps.s,
                 sizeof(ST) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                 s, N, (uint64_t)n_sets * (K / G), (uint64_t)N * sizeof(ST),
                 BN, G == 32 ? 2 : 1, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  auto kernel = grouped_kernel<T, ST>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T>());
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(1, grid_tiles, (N + BN - 1) / BN);
  kernel<<<grid, THREADS, smem_bytes<T>(), st>>>(
      maps, static_cast<const uint8_t*>(w), static_cast<const ST*>(s),
      static_cast<__nv_bfloat16*>(y), offsets, tiles, E, e0, K, N, G);
  return (int)cudaGetLastError();
}

template <typename ST>
int launch_grouped(const void* x, const void* w, const void* s, void* y,
                   const int* offsets, const int* tiles, int P, int E, int e0,
                   int n_sets, int K, int N, int G, int T, int grid_tiles,
                   cudaStream_t st) {
#define TCE_MOE_T(W)                                                        \
  case W:                                                                  \
    return launch_grouped_t<W, ST>(x, w, s, y, offsets, tiles, P, E, e0,   \
                                   n_sets, K, N, G, grid_tiles, st);
  switch (T) {
    TCE_MOE_T(16)
    TCE_MOE_T(32)
    TCE_MOE_T(64)
    TCE_MOE_T(128)
    TCE_MOE_T(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TCE_MOE_T
}

__global__ void act_kernel(const __nv_bfloat16* __restrict__ gu, int P, int F,
                           int Fp, __nv_bfloat16* __restrict__ act) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)P * Fp) return;
  const size_t r = i / Fp;
  const int c = (int)(i % Fp);
  float v = 0.f;
  if (c < F) {
    const float g = __bfloat162float(gu[r * 2 * F + c]);
    const float u = __bfloat162float(gu[r * 2 * F + F + c]);
    v = __fmul_rn(__fdiv_rn(g, __fadd_rn(1.f, expf(-g))), u);
  }
  act[i] = __float2bfloat16_rn(v);
}

__global__ void combine_kernel(const __nv_bfloat16* __restrict__ yd,
                               const int* __restrict__ slot_of,
                               const float* __restrict__ wts,
                               const __nv_bfloat16* __restrict__ x, int C,
                               int k, __nv_bfloat16* __restrict__ out) {
  const int t = blockIdx.x;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc = 0.f;
    for (int j = 0; j < k; ++j) {
      const int sl = slot_of[(size_t)t * k + j];
      acc = __fadd_rn(acc, __fmul_rn(wts[(size_t)t * k + j],
                                     __bfloat162float(yd[(size_t)sl * C + c])));
    }
    const float r = round_bf16(acc);
    out[(size_t)t * C + c] =
        __float2bfloat16_rn(__fadd_rn(__bfloat162float(x[(size_t)t * C + c]), r));
  }
}

}  // namespace moe
}  // namespace tce

// logits [n, E] f32 -> ids [n, k] int32, wts [n, k] f32 (E <= 256, k <= 32)
extern "C" int tce_moe_route(const void* logits, int n, int E, int k,
                             int norm, void* ids, void* wts, void* stream) {
  if (n < 1 || E < 1 || E > tce::moe::ROUTE_MAX_E || k < 1 || k > 32 ||
      k > E)
    return (int)cudaErrorInvalidValue;
  const int rows_a_block = 8;  // 256 threads
  tce::moe::route_kernel<<<(n + rows_a_block - 1) / rows_a_block, 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), n, E, k, norm, static_cast<int*>(ids),
      static_cast<float*>(wts));
  return (int)cudaGetLastError();
}

// ids [P] int32 (P = n k) -> src [P], slot_of [P], offsets [E + 1], tiles
// [E + 1] (int32); stats [2] int64 accumulated
extern "C" int tce_moe_plan(const void* ids, int P, int E, int k, int T,
                            void* src, void* slot_of, void* offsets,
                            void* tiles, void* stats, void* stream) {
  if (P < 1 || E < 1 || E > 256 || T < 1) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(int) * 33 * E;
  tce::moe::plan_kernel<<<1, tce::moe::PLAN_THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), P, E, k, T, static_cast<int*>(src),
      static_cast<int*>(slot_of), static_cast<int*>(offsets),
      static_cast<int*>(tiles), static_cast<long long*>(stats));
  return (int)cudaGetLastError();
}

// x [P, K] bf16 (16-byte aligned, sorted by expert); w [n_sets, K/2, N]
// uint8 and s [n_sets, K/G, N] (bf16 when scale_bf16, else f32), 16-byte
// aligned; the layer's experts are sets e0 .. e0 + E - 1; y [P, N] bf16.
// T: the token tile (16 .. 256); grid_tiles: a bound on the tiles the plan
// gives (rows past it are never computed, so it must hold them all). Needs
// K % 256 == 0, N % 16 == 0, G in {32, 64, 128}.
extern "C" int tce_moe_grouped(const void* x, const void* w, const void* s,
                               int scale_bf16, void* y, const void* offsets,
                               const void* tiles, int P, int E, int e0,
                               int n_sets, int K, int N, int G, int T,
                               int grid_tiles, void* stream) {
  if (P < 1 || K % 256 || N % 16 || (G != 32 && G != 64 && G != 128) ||
      e0 < 0 || e0 + E > n_sets || grid_tiles < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(s) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  const int* tl = static_cast<const int*>(tiles);
  return scale_bf16 ? tce::moe::launch_grouped<__nv_bfloat16>(
                          x, w, s, y, off, tl, P, E, e0, n_sets, K, N, G, T,
                          grid_tiles, st)
                    : tce::moe::launch_grouped<float>(
                          x, w, s, y, off, tl, P, E, e0, n_sets, K, N, G, T,
                          grid_tiles, st);
}

// gu [P, 2F] bf16 -> act [P, Fp] bf16 (Fp >= F, the pad columns zero)
extern "C" int tce_moe_act(const void* gu, int P, int F, int Fp, void* act,
                           void* stream) {
  if (P < 1 || F < 1 || Fp < F) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)P * Fp;
  tce::moe::act_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(gu), P, F, Fp,
      static_cast<__nv_bfloat16*>(act));
  return (int)cudaGetLastError();
}

// out [n, C] = x + combine of yd [n k, C] (bf16) at slot_of [n k] with wts
// [n k] f32
extern "C" int tce_moe_combine(const void* yd, const void* slot_of,
                               const void* wts, const void* x, int n, int C,
                               int k, void* out, void* stream) {
  if (n < 1 || C < 1 || k < 1) return (int)cudaErrorInvalidValue;
  tce::moe::combine_kernel<<<n, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(yd), static_cast<const int*>(slot_of),
      static_cast<const float*>(wts), static_cast<const __nv_bfloat16*>(x), C,
      k, static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}
