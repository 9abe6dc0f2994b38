// The decode attention body shared by csrc/flash_decode.cu (the stacked
// cache) and csrc/flash_decode_paged.cu (the page pool): one query position
// per row against its valid keys, bf16 or int8 K/V (tce::KVStore), with the
// key range split over blocks (flash-decoding).
//
// Keys at positions lo <= pos < length take part, length = lengths[b] (or
// a scalar), lo = max(length - window, 0) with a sliding window, else 0.
// The row's key range is cut into chunks of SPLIT keys counted from
// position 0: split z holds [z * SPLIT, (z + 1) * SPLIT). The partition
// depends on key position alone (not on S_max, the page size, the grid or
// whether the lengths live on the device), so the dense and the paged
// entry points, and a scalar or a [B] length, visit the same keys in the
// same tiles and give bit-identical outputs. Grid (Hkv * ceil(G / 8), B,
// n_split): one block per (b, kv head, group of up to 8 of the G query
// heads of that head, split), the wrapper's n_split covering every length
// the row may have (ceil(cap / SPLIT), cap the scalar length, S, or
// max_pages * P), without reading device lengths on the host.
//
// Inside a split, 64-key tiles at multiples of 64, staged into shared
// memory as bf16 pairs (int8 codes converted as they are staged, their
// scales beside them), with the first version's arithmetic: an online
// softmax in f32; the probabilities rounded to bf16 before the PV product
// while the running sum l takes the unrounded values (the TPU kernel's
// _flash_update). With int8 codes, the TPU kernel's quantized branch: s =
// (q . code_k) * sm_scale * k_scale[pos] (two roundings), the max and l
// over the unscaled probabilities p, then p * v_scale[pos] rounded to bf16
// against the exact codes of V, summed in f32. Each split writes its
// unnormalised acc [D], m and l to an f32 workspace; a split with no key
// (wholly at or past length, or wholly below lo) writes m = -inf, l = 0
// and nothing else. A second kernel merges the splits of each (b, query
// head) in ascending split order in f32: M = max m over the non-empty
// splits, acc = sum acc_i * exp(m_i - M), l = sum l_i * exp(m_i - M), out
// = bf16(acc / l), or zeros when no split holds a key (a row of length 0).
//
// A block holds few tiles, so the design is against latency: 256 threads;
// a tile's K/V rows come into registers 16 bytes a load, every load of a
// thread in flight at once, and the next tile's loads are issued before
// the current tile is computed; a thread's (head, key) dots share one
// staged key row (read once for its heads) and run as independent chains;
// the PV product keeps the key loop outside, so a thread's sums advance
// together.
//
// Where a key row lives is the row policy's (DenseRows: row0 + pos;
// PagedRows: page table[b, pos / P] at offset pos % P), resolved by each
// thread for the rows of its own loads, so no table entry past the row's
// last key is read and P need not divide 64.

#pragma once

#include <math.h>

#include "common.cuh"

namespace tce {
namespace decode {

constexpr int T = 64;        // keys per tile
// keys per split (the wrappers' DECODE_SPLIT): 256 ran slower at the
// short contexts of decode and no faster at 4095 keys
constexpr int SPLIT = 128;
constexpr int THREADS = 256;
constexpr int MAXG = 8;      // query heads per block

static_assert(SPLIT % T == 0, "a split holds whole tiles");

// the two bf16 values of a 32-bit word (low half first) as f32, exactly
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// key rows of one layer of the stacked cache [B, Hkv, S, D]
struct DenseRows {
  int S;
  __device__ __forceinline__ size_t operator()(int b, int h, int Hkv,
                                               int pos) const {
    return ((size_t)b * Hkv + h) * S + pos;
  }
};

// key rows of one layer of the page pool [n_pages, Hkv, P, D]
struct PagedRows {
  const int* table;
  int max_pages, P;
  __device__ __forceinline__ size_t operator()(int b, int h, int Hkv,
                                               int pos) const {
    const size_t page = (size_t)table[(size_t)b * max_pages + pos / P];
    return (page * Hkv + h) * P + pos % P;
  }
};

// the partial of one (b, kv head, head group, split) into ws_acc
// [B * Hq, n_split, D] and ws_ml [B * Hq, n_split, 2] (m, l)
template <int D, typename KV, typename Rows>
__global__ void __launch_bounds__(THREADS) split_kernel(
    const __nv_bfloat16* __restrict__ q, const KV* __restrict__ k,
    const KV* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, float* __restrict__ ws_acc,
    float* __restrict__ ws_ml, int Hq, int Hkv, Rows rows,
    const int* __restrict__ lengths, int len_scalar, int window,
    float sm_scale) {
  using St = KVStore<KV>;
  constexpr int VPR = D * (int)sizeof(KV) / 16;  // 16-byte vectors a row
  constexpr int NLD = T * VPR / THREADS;  // of K and of V a thread, a tile
  constexpr int WPV = 16 / (int)sizeof(KV) / 2;  // staged words a vector
  constexpr int NS = MAXG * T / THREADS;  // (head, key) dots a thread
  constexpr int NACC = MAXG * D / THREADS;  // PV outputs a thread
  // a staged bf16 row in 32-bit words, padded by 16 bytes: the per-key
  // dots read it 16 bytes at a time, conflict-free across 8 keys
  constexpr int RW = D / 2 + 4;
  __shared__ __align__(16) uint32_t ks[T][RW];
  __shared__ __align__(16) uint32_t vs[T][RW];
  __shared__ __align__(16) float qs[MAXG][D];
  __shared__ float ksc[St::kInt8 ? T : 1], vsc[St::kInt8 ? T : 1];
  __shared__ float ss[MAXG][T];
  __shared__ float m_s[MAXG], l_s[MAXG], alpha_s[MAXG];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int G = Hq / Hkv, nblk = (G + MAXG - 1) / MAXG;
  const int h = blockIdx.x / nblk, b = blockIdx.y, z = blockIdx.z;
  const int n_split = gridDim.z;
  const int g0 = (blockIdx.x % nblk) * MAXG, GB = min(MAXG, G - g0);
  const int length = lengths ? lengths[b] : len_scalar;
  const int lo = window > 0 ? max(length - window, 0) : 0;
  const int c0 = z * SPLIT;
  const int begin = max(c0, lo), end = min(c0 + SPLIT, length);
  const size_t head0 = (size_t)b * Hq + h * G + g0;  // the block's first head
  if (begin >= end) {  // no key of this row in the chunk: an empty partial
    if (tid < GB) {
      ws_ml[((head0 + tid) * n_split + z) * 2] = -INFINITY;
      ws_ml[((head0 + tid) * n_split + z) * 2 + 1] = 0.f;
    }
    return;
  }
  const uint4* kg = reinterpret_cast<const uint4*>(k);
  const uint4* vg = reinterpret_cast<const uint4*>(v);

  for (int i = tid; i < MAXG * D; i += THREADS)
    qs[i / D][i % D] = i < GB * D ? __bfloat162float(q[head0 * D + i]) : 0.f;
  if (tid < MAXG) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[NACC];
#pragma unroll
  for (int r = 0; r < NACC; ++r) acc[r] = 0.f;

  // a tile's K/V rows in registers, 16 bytes a load, all of a thread's
  // loads in flight at once; keys outside [begin, end) are zeros
  uint4 kr[NLD], vr[NLD];
  float ksr = 0.f, vsr = 0.f;
  auto load = [&](int t0) {
#pragma unroll
    for (int j = 0; j < NLD; ++j) {
      const int idx = tid + THREADS * j, pos = t0 + idx / VPR;
      kr[j] = vr[j] = make_uint4(0u, 0u, 0u, 0u);
      if (pos >= begin && pos < end) {
        const size_t at = rows(b, h, Hkv, pos) * VPR + idx % VPR;
        kr[j] = __ldg(kg + at);
        vr[j] = __ldg(vg + at);
      }
    }
    if (St::kInt8 && tid < T) {
      const int pos = t0 + tid;
      const bool ok = pos >= begin && pos < end;
      const size_t row = ok ? rows(b, h, Hkv, pos) : 0;
      ksr = ok ? k_scale[row] : 0.f;
      vsr = ok ? v_scale[row] : 0.f;
    }
  };

  int t0 = c0 + (begin - c0) / T * T;
  load(t0);
  for (; t0 < end; t0 += T) {
    const int ta = max(begin - t0, 0), tb = min(end - t0, T);  // keys [ta, tb)
#pragma unroll
    for (int j = 0; j < NLD; ++j) {
      const int idx = tid + THREADS * j, r = idx / VPR, c = idx % VPR;
      St::stage16(kr[j], &ks[r][c * WPV]);
      St::stage16(vr[j], &vs[r][c * WPV]);
    }
    if (St::kInt8 && tid < T) {
      ksc[tid] = ksr;
      vsc[tid] = vsr;
    }
    __syncthreads();
    if (t0 + T < end) load(t0 + T);  // the next tile's loads fly meanwhile
    {  // key t = tid % T against heads tid / T + (THREADS / T) u
      const int t = tid % T;
      float dot[NS];
#pragma unroll
      for (int u = 0; u < NS; ++u) dot[u] = 0.f;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const uint4 k8 = *reinterpret_cast<const uint4*>(&ks[t][4 * c]);
        const float kf[8] = {bf16_lo(k8.x), bf16_hi(k8.x), bf16_lo(k8.y),
                             bf16_hi(k8.y), bf16_lo(k8.z), bf16_hi(k8.z),
                             bf16_lo(k8.w), bf16_hi(k8.w)};
#pragma unroll
        for (int u = 0; u < NS; ++u) {
          const float* qg = &qs[tid / T + (THREADS / T) * u][8 * c];
          const float4 qa = *reinterpret_cast<const float4*>(qg);
          const float4 qb = *reinterpret_cast<const float4*>(qg + 4);
          dot[u] = fmaf(qa.x, kf[0], dot[u]);
          dot[u] = fmaf(qa.y, kf[1], dot[u]);
          dot[u] = fmaf(qa.z, kf[2], dot[u]);
          dot[u] = fmaf(qa.w, kf[3], dot[u]);
          dot[u] = fmaf(qb.x, kf[4], dot[u]);
          dot[u] = fmaf(qb.y, kf[5], dot[u]);
          dot[u] = fmaf(qb.z, kf[6], dot[u]);
          dot[u] = fmaf(qb.w, kf[7], dot[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < NS; ++u) {
        const int g = tid / T + (THREADS / T) * u;
        if (g < GB) {
          const float s = St::kInt8 ? scaled_score(dot[u], sm_scale, ksc[t])
                                    : dot[u] * sm_scale;
          ss[g][t] = t >= ta && t < tb ? s : NEG_INF;
        }
      }
    }
    __syncthreads();
    for (int g = warp; g < GB; g += THREADS / 32) {
      const float s0 = ss[g][lane], s1 = ss[g][lane + 32];
      const bool ok0 = lane >= ta && lane < tb;
      const bool ok1 = lane + 32 >= ta && lane + 32 < tb;
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
      const float psum = warp_sum(p0 + p1);  // l: unscaled
      if (St::kInt8) {
        ss[g][lane] = round_bf16(__fmul_rn(p0, vsc[lane]));
        ss[g][lane + 32] = round_bf16(__fmul_rn(p1, vsc[lane + 32]));
      } else {
        ss[g][lane] = round_bf16(p0);
        ss[g][lane + 32] = round_bf16(p1);
      }
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[g] = l_s[g] * alpha + psum;
        m_s[g] = m_new;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();
    // acc = acc * alpha + sum over the tile's keys in order of p * v, the
    // key loop outside so that a thread's NACC sums advance together
#pragma unroll
    for (int r = 0; r < NACC; ++r) {
      const int i = tid + THREADS * r;
      if (i < GB * D) acc[r] *= alpha_s[i / D];
    }
#pragma unroll 4
    for (int t = ta; t < tb; ++t) {
      const __nv_bfloat16* vrow =
          reinterpret_cast<const __nv_bfloat16*>(&vs[t][0]);
#pragma unroll
      for (int r = 0; r < NACC; ++r) {
        const int i = tid + THREADS * r;
        if (i < GB * D)
          acc[r] = fmaf(ss[i / D][t], __bfloat162float(vrow[i % D]), acc[r]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < NACC; ++r) {
    const int i = tid + THREADS * r;
    if (i < GB * D)
      ws_acc[((head0 + i / D) * n_split + z) * D + i % D] = acc[r];
  }
  if (tid < GB) {
    ws_ml[((head0 + tid) * n_split + z) * 2] = m_s[tid];
    ws_ml[((head0 + tid) * n_split + z) * 2 + 1] = l_s[tid];
  }
}

// out[head, :] from the splits of one (b, query head), in ascending split
// order; one block per head, one thread per element
template <int D>
__global__ void __launch_bounds__(D) combine_kernel(
    const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
    __nv_bfloat16* __restrict__ out, int n_split) {
  const size_t head = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = ws_ml + head * n_split * 2;
  float m_max = -INFINITY;
  for (int z = 0; z < n_split; ++z)
    if (ml[2 * z + 1] > 0.f) m_max = fmaxf(m_max, ml[2 * z]);
  float acc = 0.f, l = 0.f;
  for (int z = 0; z < n_split; ++z) {
    const float lz = ml[2 * z + 1];
    if (lz > 0.f) {
      const float w = expf(ml[2 * z] - m_max);
      acc = fmaf(ws_acc[(head * n_split + z) * D + d], w, acc);
      l = fmaf(lz, w, l);
    }
  }
  out[head * D + d] = __float2bfloat16(l > 0.f ? acc / l : 0.f);
}

// Both kernels on ``stream``; ws holds B * Hq * n_split * (D + 2) floats,
// n_split splits of SPLIT keys covering every length. Returns
// cudaGetLastError() after the launches.
template <typename KV, typename Rows>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, void* out, void* ws, int B, int Hq, int Hkv,
           int D, Rows rows, const void* lengths, int len_scalar, int window,
           float sm_scale, int n_split, void* stream) {
  if (n_split < 1 || Hkv < 1 || Hq % Hkv ||
      (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  const dim3 grid(Hkv * ((G + MAXG - 1) / MAXG), B, n_split);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const KV*>(k);
  const auto* vp = static_cast<const KV*>(v);
  const auto* ksp = static_cast<const float*>(k_scale);
  const auto* vsp = static_cast<const float*>(v_scale);
  auto* op = static_cast<__nv_bfloat16*>(out);
  const int* lp = static_cast<const int*>(lengths);
  float* ws_acc = static_cast<float*>(ws);
  float* ws_ml = ws_acc + (size_t)B * Hq * n_split * D;
  if (D == 64)
    split_kernel<64, KV, Rows><<<grid, THREADS, 0, st>>>(
        qp, kp, vp, ksp, vsp, ws_acc, ws_ml, Hq, Hkv, rows, lp, len_scalar,
        window, sm_scale);
  else
    split_kernel<128, KV, Rows><<<grid, THREADS, 0, st>>>(
        qp, kp, vp, ksp, vsp, ws_acc, ws_ml, Hq, Hkv, rows, lp, len_scalar,
        window, sm_scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (D == 64)
    combine_kernel<64><<<B * Hq, 64, 0, st>>>(ws_acc, ws_ml, op, n_split);
  else
    combine_kernel<128><<<B * Hq, 128, 0, st>>>(ws_acc, ws_ml, op, n_split);
  return (int)cudaGetLastError();
}

}  // namespace decode
}  // namespace tce
