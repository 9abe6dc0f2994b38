// Single-token SmoothQuant (Int8OPT) attention over the raw int8 stacked
// KV cache.
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
// Bound on the H100: bytes (K and V of the valid keys, 2 * length * D bytes
// per (b, h)). The TPU kernel walks K twice because its grid keeps no row
// of scores; here one block per (b, h) computes the int32 scores once
// (__dp4a over 16-byte K loads, one key per thread) and keeps them in
// shared memory, reduces the max and the sum over the block, quantizes the
// probabilities, then accumulates PV in int32 with each thread on one
// 4-byte word of a V row (a warp reads whole rows) and the key range split
// over the block's groups of threads, summed in a fixed order at the end.
// Rows longer than CHUNK keys recompute their scores chunk by chunk in
// each of the three passes (max, sum, requant + PV): the same function.
// expf and an IEEE division, not the fast intrinsics, so the probabilities
// round as the plain versions' do. Only B * H blocks run (32 at B = 1 for
// opt_6.7b); a split of the key range over blocks is later work.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 4096;  // keys whose scores stay in shared memory

template <int D>
__device__ __forceinline__ void chunk_scores(
    const int (&qw)[D / 4], const int8_t* __restrict__ kb, int c0, int n,
    float qk_alpha, float* sc) {
  for (int t = threadIdx.x; t < n; t += THREADS) {
    const int4* kr = reinterpret_cast<const int4*>(kb + (size_t)(c0 + t) * D);
    int dot = 0;
#pragma unroll
    for (int i = 0; i < D / 16; ++i) {
      const int4 kv = __ldg(kr + i);
      dot = __dp4a(qw[4 * i + 0], kv.x, dot);
      dot = __dp4a(qw[4 * i + 1], kv.y, dot);
      dot = __dp4a(qw[4 * i + 2], kv.z, dot);
      dot = __dp4a(qw[4 * i + 3], kv.w, dot);
    }
    sc[t] = (float)dot * qk_alpha;
  }
}

// block-wide max or sum, combined over the warps in a fixed order
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  v = MAX ? tce::warp_max(v) : tce::warp_sum(v);
  __syncthreads();  // red is reused
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < THREADS / 32; ++w)
    r = MAX ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

template <int D>
__global__ void __launch_bounds__(THREADS) int8_decode_kernel(
    const int8_t* __restrict__ q, const int8_t* __restrict__ k,
    const int8_t* __restrict__ v, float* __restrict__ out, int H, int S,
    const int* __restrict__ lengths, int len_scalar,
    const float* __restrict__ qk_alpha_p, float qk_alpha_scalar,
    const float* __restrict__ pv_alpha_p, float pv_alpha_scalar) {
  constexpr int WPR = D / 4;             // 4-byte words per K/V row
  constexpr int GROUPS = THREADS / WPR;  // key groups of the PV pass
  __shared__ float sc[CHUNK];
  __shared__ int8_t ps[CHUNK];
  __shared__ int accs[GROUPS][D];
  __shared__ float red[THREADS / 32];

  const int tid = threadIdx.x;
  const size_t row = (size_t)blockIdx.y * H + blockIdx.x;  // (b, h)
  const int length = lengths ? lengths[blockIdx.y] : len_scalar;
  float* o = out + row * D;
  if (length <= 0) {
    for (int i = tid; i < D; i += THREADS) o[i] = 0.f;
    return;
  }
  const float qk_alpha = qk_alpha_p ? *qk_alpha_p : qk_alpha_scalar;
  const float pv_alpha = pv_alpha_p ? *pv_alpha_p : pv_alpha_scalar;
  const int8_t* kb = k + row * S * D;
  const int8_t* vb = v + row * S * D;
  int qw[WPR];
  const int* q32 = reinterpret_cast<const int*>(q + row * D);
#pragma unroll
  for (int i = 0; i < WPR; ++i) qw[i] = q32[i];

  const int n_chunks = (length + CHUNK - 1) / CHUNK;
  const bool resident = n_chunks == 1;  // scores computed once

  float m = tce::NEG_INF;  // pass 1: the row's max
  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * CHUNK, n = min(CHUNK, length - c0);
    __syncthreads();
    chunk_scores<D>(qw, kb, c0, n, qk_alpha, sc);
    for (int t = tid; t < n; t += THREADS) m = fmaxf(m, sc[t]);
  }
  m = block_reduce<true>(m, red);

  float l = 0.f;  // pass 2: the row's sum
  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * CHUNK, n = min(CHUNK, length - c0);
    if (!resident) {
      __syncthreads();
      chunk_scores<D>(qw, kb, c0, n, qk_alpha, sc);
    }
    for (int t = tid; t < n; t += THREADS) l += expf(sc[t] - m);
  }
  l = block_reduce<false>(l, red);
  const float denom = fmaxf(l, 1e-30f);

  // pass 3: the x127 requant against the final stats, then int32 PV
  const int w = tid % WPR, g = tid / WPR;
  int acc[4] = {0, 0, 0, 0};
  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * CHUNK, n = min(CHUNK, length - c0);
    if (!resident) {
      __syncthreads();
      chunk_scores<D>(qw, kb, c0, n, qk_alpha, sc);
    }
    __syncthreads();  // the scores are complete; ps is free
    for (int t = tid; t < n; t += THREADS) {
      const float p = expf(sc[t] - m) / denom;
      ps[t] = (int8_t)fminf(fmaxf(rintf(p * 127.f), -128.f), 127.f);
    }
    __syncthreads();
    for (int t = g; t < n; t += GROUPS) {
      const int p = ps[t];
      const uint32_t vw =
          reinterpret_cast<const uint32_t*>(vb + (size_t)(c0 + t) * D)[w];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[j] += p * (int)(int8_t)(vw >> (8 * j));
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) accs[g][4 * w + j] = acc[j];
  __syncthreads();
  for (int d = tid; d < D; d += THREADS) {
    int s = 0;
    for (int gg = 0; gg < GROUPS; ++gg) s += accs[gg][d];
    o[d] = (float)s * pv_alpha;
  }
}

}  // namespace

// q [B, H, D] int8; k, v: one layer [B, H, S, D] int8; out [B, H, D] f32.
// lengths: device int32 [B], or null to use len_scalar for every b. Each
// alpha: a device f32 scalar, or null to use the float given beside it.
// Needs D in {64, 128}.
extern "C" int tce_int8_decode(const void* q, const void* k, const void* v,
                               void* out, int B, int H, int S, int D,
                               const void* lengths, int len_scalar,
                               const void* qk_alpha, float qk_alpha_scalar,
                               const void* pv_alpha, float pv_alpha_scalar,
                               void* stream) {
  const dim3 grid(H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* kp = static_cast<const int8_t*>(k);
  const auto* vp = static_cast<const int8_t*>(v);
  auto* op = static_cast<float*>(out);
  const int* lp = static_cast<const int*>(lengths);
  const auto* qa = static_cast<const float*>(qk_alpha);
  const auto* pa = static_cast<const float*>(pv_alpha);
  if (D == 64)
    int8_decode_kernel<64><<<grid, THREADS, 0, st>>>(
        qp, kp, vp, op, H, S, lp, len_scalar, qa, qk_alpha_scalar, pa,
        pv_alpha_scalar);
  else if (D == 128)
    int8_decode_kernel<128><<<grid, THREADS, 0, st>>>(
        qp, kp, vp, op, H, S, lp, len_scalar, qa, qk_alpha_scalar, pa,
        pv_alpha_scalar);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
