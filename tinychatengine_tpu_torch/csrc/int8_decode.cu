// Single-token SmoothQuant (Int8OPT) attention over the raw int8 stacked
// KV cache, the key range split over blocks.
//
// Replaces: tinychatengine_tpu/ops/attention.py · int8_decode
// (body _int8_decode_kernel, pallas_call site :708).
//
// q [B, H, D] int8 against one layer of the cache, k/v [B, H, S, D] int8
// with no scales (multi-head: one KV head per query head; the wrapper
// offsets the pointers to the layer). For the keys t < lengths[b]:
//   s_t  = float(q . k_t, summed in int32) * qk_alpha
//   p_t  = expf(s_t - m) / max(l, 1e-30)   (m, l: the row's FINAL max and
//                                           sum, never running ones)
//   p_s8 = clip(rint(p_t * 127), -128, 127)   (round half to even)
//   out  = float(sum_t p_s8 * v_t, summed in int32) * pv_alpha, f32.
// A row of length 0 gives zeros, as the TPU kernel's blocks never run.
//
// Bound on the H100: bytes (K and V of the valid keys, 2 * length * D
// bytes per (b, h)); at decode sizes (320 keys: 80 KB a row) the time is
// latency, not bandwidth. Design:
// - The row's keys are cut into chunks of CH keys counted from position 0;
//   chunk c holds [c * CH, (c + 1) * CH). The grid covers the chunks any
//   row may hold (the wrapper's n_chunks, from the scalar length or S, never
//   from a device read), and a block of a row's C blocks takes chunks
//   rank, rank + C, ... So a row's bits depend on key positions alone: not
//   on S, B, C or whether the length is a scalar or a tensor.
// - At its start a block starts cp.async copies of both K and V of its
//   first chunk (the rest of its chunks, rows past C * 64 keys, are read in
//   place), so V arrives while the scores and the softmax statistics are
//   computed; each byte comes from device memory once. Staging more chunks
//   ran slower at 8 ragged rows: the shared memory held per block cut the
//   blocks in flight.
// - A block loops only over its chunks that hold keys (the row's length
//   is read on the device), and a block with none waits at the barriers.
// - Each chunk's int32 dots (__dp4a, two threads a key) give its scores,
//   kept in shared memory, and its (m_c, l_c): the max and the sum of
//   exp(s - m_c) over its valid keys ((-1e30, 0) for an empty chunk).
// - The row's (m, l) merge the chunks in one fixed order, chunk c on lane
//   c % 32, then a butterfly over the lanes: m = max m_c, l = sum l_c
//   exp(m_c - m). Every block of the row computes it identically; chunks
//   past the length add exact zeros and change no bit.
// - Each block then requantizes its probabilities against (m, l) and forms
//   its int32 PV partial; integer sums are exact in any order (|sum p v| <=
//   127 * 127 * S), so the partials add up to the TPU kernel's sum, which
//   one step scales by pv_alpha.
// - The row's C blocks form one thread-block cluster (the wrapper's
//   int8_cluster: up to 8 where the row's length is known on the host, so
//   every block holds keys; up to 4 where the grid covers S for device
//   lengths, so a short row leaves fewer blocks empty), co-resident by
//   construction: each block's chunk statistics stay in
//   its shared memory and the others read them through distributed shared
//   memory after a cluster barrier; each block then adds its partial into
//   rank 0's total by shared-memory atomics, and after a second barrier
//   rank 0 writes the row. (Two launches, statistics then requant and PV
//   through a workspace, ran slower at every measured shape: PERF.md.)
// expf and an IEEE division, not the fast intrinsics, so the probabilities
// round as the plain versions' do.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CH = 64;        // keys per chunk (the wrappers' INT8_SPLIT)
constexpr int THREADS = 128;  // two threads a key
constexpr int TPK = THREADS / CH;
constexpr int MAX_CLUSTER = 8;

struct Args {
  const int8_t* q;
  const int8_t* k;
  const int8_t* v;
  float* out;
  int H, S;
  const int* lengths;
  int len_scalar;
  const float* qk_alpha_p;
  float qk_alpha_scalar;
  const float* pv_alpha_p;
  float pv_alpha_scalar;
  int n_chunks, C, n_per;
};

// the dynamic shared memory of a block (byte offsets): the staged K then
// V chunk, the block's scores, requantized probabilities, chunk statistics
// and the PV loop's per-group sums
template <int D>
struct Smem {
  static constexpr int SC = 2 * CH * D;
  static __host__ __device__ int ps(int n_per) { return SC + n_per * CH * 4; }
  static __host__ __device__ int stats(int n_per) {
    return (ps(n_per) + n_per * CH + 15) / 16 * 16;
  }
  static __host__ __device__ int accs(int n_per) {
    return stats(n_per) + n_per * 8;
  }
  static __host__ __device__ int bytes(int n_per) {
    return accs(n_per) + (THREADS / (D / 4)) * D * 4;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Row {
  int b, h, rank, length;
  int n_real;  // the row's chunks that hold a key: ceil(length / CH)
  int n_mine;  // those this block takes (rank, rank + C, ...)
  size_t row;  // b * H + h
  float qk_alpha, pv_alpha;
};

__device__ __forceinline__ Row row_of(const Args& a, int rank) {
  Row r;
  r.b = blockIdx.z;
  r.h = blockIdx.y;
  r.rank = rank;
  r.row = (size_t)r.b * a.H + r.h;
  r.length = a.lengths ? a.lengths[r.b] : a.len_scalar;
  r.n_real = min(a.n_chunks, (max(r.length, 0) + CH - 1) / CH);
  r.n_mine = rank < r.n_real ? (r.n_real - 1 - rank) / a.C + 1 : 0;
  r.qk_alpha = a.qk_alpha_p ? *a.qk_alpha_p : a.qk_alpha_scalar;
  r.pv_alpha = a.pv_alpha_p ? *a.pv_alpha_p : a.pv_alpha_scalar;
  return r;
}

// the valid keys of chunk c of a row of `length` keys
__device__ __forceinline__ int chunk_keys(int c, int length) {
  return max(0, min(CH, length - c * CH));
}

// cp.async copies of the valid keys of the block's first chunk (chunk
// rank), K or V, as one commit group
template <int D>
__device__ __forceinline__ void stage(const Args& a, const Row& r,
                                      const int8_t* src, int8_t* dst) {
  constexpr int CPR = D / 16;
  const int8_t* base = src + (r.row * a.S + (size_t)r.rank * CH) * D;
  const int n = chunk_keys(r.rank, r.length);
  for (int i = threadIdx.x; i < n * CPR; i += THREADS)
    cp_async16(smem_u32(dst + i * 16), base + i * 16);
  cp_async_commit();
}

// the block's scores (-1e30 past the length) into sc: its first chunk's
// from the staged K, the rest in place
template <int D>
__device__ __forceinline__ void scores(const Args& a, const Row& r,
                                       const int8_t* ks, float* sc) {
  constexpr int W = D / TPK / 4;  // 32-bit words of a key a thread dots
  const int key = threadIdx.x / TPK, part = threadIdx.x % TPK;
  int qw[W];
  const int* q32 = reinterpret_cast<const int*>(a.q + r.row * D) + part * W;
#pragma unroll
  for (int i = 0; i < W; ++i) qw[i] = q32[i];
  const int8_t* kg = a.k + r.row * a.S * D;
  for (int j = 0; j < r.n_mine; ++j) {
    const int c = r.rank + j * a.C;
    const bool valid = key < chunk_keys(c, r.length);
    int dot = 0;
    if (valid) {
      const int8_t* kr = j == 0 ? ks + key * D
                                : kg + ((size_t)c * CH + key) * D;
      const int4* k4 = reinterpret_cast<const int4*>(kr) + part * (W / 4);
#pragma unroll
      for (int i = 0; i < W / 4; ++i) {
        const int4 kv = k4[i];
        dot = __dp4a(qw[4 * i + 0], kv.x, dot);
        dot = __dp4a(qw[4 * i + 1], kv.y, dot);
        dot = __dp4a(qw[4 * i + 2], kv.z, dot);
        dot = __dp4a(qw[4 * i + 3], kv.w, dot);
      }
    }
#pragma unroll
    for (int o = 1; o < TPK; o <<= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (part == 0)
      sc[j * CH + key] = valid ? (float)dot * r.qk_alpha : tce::NEG_INF;
  }
}

// each chunk's (m_c, l_c) over its valid keys, one warp a chunk
__device__ __forceinline__ void chunk_stats(const Row& r, const float* sc,
                                            float2* st) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j = warp; j < r.n_mine; j += THREADS / 32) {
    const float s0 = sc[j * CH + lane], s1 = sc[j * CH + 32 + lane];
    const float m = tce::warp_max(fmaxf(s0, s1));
    float e = 0.f;
    if (s0 != tce::NEG_INF) e += expf(s0 - m);
    if (s1 != tce::NEG_INF) e += expf(s1 - m);
    st[j] = make_float2(m, tce::warp_sum(e));
  }
}

// the row's (m, l) from the statistics of its n_real chunks that hold a
// key, in one fixed order: chunk c on lane c % 32 (ascending), then a
// butterfly over the lanes. stat(c) fetches chunk c's (m_c, l_c).
template <typename Stat>
__device__ __forceinline__ float2 merge(int n_chunks, Stat stat) {
  const int lane = threadIdx.x % 32;
  float m = tce::NEG_INF;
  for (int c = lane; c < n_chunks; c += 32) m = fmaxf(m, stat(c).x);
  m = tce::warp_max(m);
  float l = 0.f;
  for (int c = lane; c < n_chunks; c += 32) {
    const float2 s = stat(c);
    l += s.y * expf(s.x - m);  // an empty chunk: 0 * 0
  }
  return make_float2(m, tce::warp_sum(l));
}

// requantize the block's probabilities against (m, l) into ps, then its
// int32 PV partial (the first chunk's V staged, the rest in place) into
// part [D]
template <int D>
__device__ __forceinline__ void requant_pv(const Args& a, const Row& r,
                                           float2 ml, const float* sc,
                                           int8_t* ps, const int8_t* vs,
                                           int* accs, int* part) {
  constexpr int WPR = D / 4;             // 32-bit words of a V row
  constexpr int GROUPS = THREADS / WPR;  // key groups of the PV loop
  const float denom = fmaxf(ml.y, 1e-30f);
  for (int i = threadIdx.x; i < r.n_mine * CH; i += THREADS) {
    const float s = sc[i];
    int8_t p = 0;
    if (s != tce::NEG_INF)
      p = (int8_t)fminf(fmaxf(rintf(expf(s - ml.x) / denom * 127.f), -128.f),
                        127.f);
    ps[i] = p;
  }
  __syncthreads();
  const int w = threadIdx.x % WPR, g = threadIdx.x / WPR;
  const int8_t* vg = a.v + r.row * a.S * D;
  int acc[4] = {0, 0, 0, 0};
  for (int j = 0; j < r.n_mine; ++j) {
    const int c = r.rank + j * a.C;
    const int n = chunk_keys(c, r.length);
    const int8_t* vc = j == 0 ? vs : vg + (size_t)c * CH * D;
    for (int t = g; t < n; t += GROUPS) {
      const int p = ps[j * CH + t];
      const uint32_t vw = reinterpret_cast<const uint32_t*>(vc + t * D)[w];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[e] += p * (int)(int8_t)(vw >> (8 * e));
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) accs[g * D + 4 * w + e] = acc[e];
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += THREADS) {
    int s = 0;
    for (int gg = 0; gg < GROUPS; ++gg) s += accs[gg * D + d];
    part[d] = s;
  }
}

// grid (C, H, B), one cluster of C blocks a row
template <int D>
__global__ void __launch_bounds__(THREADS) int8_decode_cluster(Args a) {
  using Sm = Smem<D>;
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Row r = row_of(a, (int)cluster.block_rank());
  int8_t* kst = reinterpret_cast<int8_t*>(smem);
  int8_t* vst = kst + CH * D;
  float* sc = reinterpret_cast<float*>(smem + Sm::SC);
  int8_t* ps = reinterpret_cast<int8_t*>(smem + Sm::ps(a.n_per));
  float2* st = reinterpret_cast<float2*>(smem + Sm::stats(a.n_per));
  int* accs = reinterpret_cast<int*>(smem + Sm::accs(a.n_per));
  __shared__ int part[D], total[D];

  stage<D>(a, r, a.k, kst);
  stage<D>(a, r, a.v, vst);
  for (int d = threadIdx.x; d < D; d += THREADS) total[d] = 0;
  if (r.n_mine > 0) {
    cp_async_wait<1>();  // K has landed; V is in flight
    __syncthreads();
    scores<D>(a, r, kst, sc);
    __syncthreads();
    chunk_stats(r, sc, st);
  }
  cluster.sync();  // every block's chunk statistics are written

  if (r.n_mine > 0) {  // a block with no chunk holding a key adds nothing
    const float2 ml = merge(r.n_real, [&](int c) {
      const float2* o = cluster.map_shared_rank(st, c % a.C);
      return o[c / a.C];
    });
    cp_async_wait<0>();  // V
    __syncthreads();
    requant_pv<D>(a, r, ml, sc, ps, vst, accs, part);
    // add the partial into rank 0's total (exact in any order)
    int* total0 = cluster.map_shared_rank(total, 0);
    for (int d = threadIdx.x; d < D; d += THREADS)
      atomicAdd(total0 + d, part[d]);
  }
  cluster.sync();  // the total is complete; no block reads another after
  if (r.rank == 0)
    for (int d = threadIdx.x; d < D; d += THREADS)
      a.out[r.row * D + d] = (float)total[d] * r.pv_alpha;
}

template <int D>
int launch(const Args& a, int B, cudaStream_t st) {
  const int bytes = Smem<D>::bytes(a.n_per);
  constexpr int MAX_BYTES = 232448 - 1024;  // the card's 227 KB, less static
  static bool configured = false;  // once, outside any CUDA graph capture
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        int8_decode_cluster<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_BYTES);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  if (bytes > MAX_BYTES) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.C, a.H, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, int8_decode_cluster<D>, a);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

// q [B, H, D] int8; k, v: one layer [B, H, S, D] int8; out [B, H, D] f32.
// lengths: device int32 [B], or null to use len_scalar for every b. Each
// alpha: a device f32 scalar, or null to use the float given beside it.
// n_chunks: ceil(cap / 64) for the longest length a row may have (the
// scalar length, or S), at least 1; cluster: the blocks of a row, 1 to 8
// and at most n_chunks. Needs D in {64, 128}.
extern "C" int tce_int8_decode(const void* q, const void* k, const void* v,
                               void* out, int B, int H, int S, int D,
                               const void* lengths, int len_scalar,
                               const void* qk_alpha, float qk_alpha_scalar,
                               const void* pv_alpha, float pv_alpha_scalar,
                               int n_chunks, int cluster, void* stream) {
  if (cluster < 1 || cluster > MAX_CLUSTER || cluster > n_chunks)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const int8_t*>(q);
  a.k = static_cast<const int8_t*>(k);
  a.v = static_cast<const int8_t*>(v);
  a.out = static_cast<float*>(out);
  a.H = H;
  a.S = S;
  a.lengths = static_cast<const int*>(lengths);
  a.len_scalar = len_scalar;
  a.qk_alpha_p = static_cast<const float*>(qk_alpha);
  a.qk_alpha_scalar = qk_alpha_scalar;
  a.pv_alpha_p = static_cast<const float*>(pv_alpha);
  a.pv_alpha_scalar = pv_alpha_scalar;
  a.n_chunks = n_chunks;
  a.C = cluster;
  a.n_per = (n_chunks + a.C - 1) / a.C;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(a, B, st);
  if (D == 128) return launch<128>(a, B, st);
  return (int)cudaErrorInvalidValue;
}
