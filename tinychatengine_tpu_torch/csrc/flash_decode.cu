// Single-token attention over the layer-stacked KV cache, bf16 or int8.
//
// Replaces: tinychatengine_tpu/ops/attention.py · flash_decode
// (body _decode_kernel, pallas_call site :194), both of its branches.
//
// q [B, Hq, D] bf16 against one layer of the cache, k/v [B, Hkv, S, D]
// (the wrapper offsets the pointers to the layer): bf16 values, or int8
// codes with f32 scales k_scale/v_scale [B, Hkv, S] (kv_cache_dtype
// "int8"). Keys at positions lo <= pos < lengths[b] take part, lo =
// max(length - window, 0) with a sliding window, else 0. Online softmax in
// fp32; the probabilities are rounded to bf16 before the PV product while
// the running sum l takes the unrounded values (the TPU kernel's
// _flash_update). With int8 codes the arithmetic is the TPU kernel's
// quantized branch, not a dequantize-to-bf16: s = (q . code_k) * sm_scale
// * k_scale[pos] (two roundings), the running max and l over the unscaled
// probabilities p, then p * v_scale[pos] rounded to bf16 against the exact
// codes of V, accumulated in fp32.
//
// Bound on the H100: bytes (the valid K/V prefix, 2 * length * D * 2 bytes
// per (b, kv head) in bf16; 2 * length * (D + 4) with int8 codes and their
// scales). One block per (b, kv head, group of up to 8 of the G query
// heads sharing that KV head), so each K/V tile is read once for up to 8
// heads: one block per KV head under GQA (G <= 8), ceil(G / 8) under MQA
// (StarCoder's G = 48 takes 6, each reading the head's K/V itself). The
// loop visits only the valid range (no fixed grid over S_max, so the TPU
// path's ctx_cap is not needed). K/V tiles of 64 positions go through
// shared memory as bf16 pairs with rows padded by one word, so the per-key
// score dots read conflict-free. An int8 tile reads half the bytes from
// device memory and is converted to bf16 as it is staged (exact for the
// codes; tce::KVStore), once per tile rather than once per query head
// that reads it; the tile's 64 K and V scales sit in shared memory beside
// it. Only B * Hkv * ceil(G / 8) blocks run (8 for llama3_8b and 6 for
// StarCoder at B = 1), which leaves most SMs idle at long contexts:
// splitting the key range over blocks (flash-decoding) is later work.

#include "common.cuh"

namespace {

constexpr int T = 64;        // keys per tile
constexpr int THREADS = 128;
constexpr int MAXG = 8;      // query heads per KV head

template <int D, typename KV>
__global__ void __launch_bounds__(THREADS) flash_decode_kernel(
    const __nv_bfloat16* __restrict__ q, const KV* __restrict__ k,
    const KV* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, __nv_bfloat16* __restrict__ out,
    int Hq, int Hkv, int S, const int* __restrict__ lengths, int len_scalar,
    int window, float sm_scale) {
  using St = tce::KVStore<KV>;
  constexpr int WPR = D / St::kPerWord;  // device words per K/V row
  constexpr int DW = D / 2 + 1;  // staged bf16 row, padded, in 32-bit words
  __shared__ float qs[MAXG][D];
  __shared__ uint32_t ks[T][DW];
  __shared__ uint32_t vs[T][DW];
  __shared__ float ksc[St::kInt8 ? T : 1], vsc[St::kInt8 ? T : 1];
  __shared__ float ss[MAXG][T];
  __shared__ float m_s[MAXG], l_s[MAXG], alpha_s[MAXG];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // block x = (kv head h, group block): up to MAXG of the G query heads
  // that share KV head h (MQA's G = 48 takes six blocks per head)
  const int G = Hq / Hkv, nblk = (G + MAXG - 1) / MAXG;
  const int h = blockIdx.x / nblk, b = blockIdx.y;
  const int g0 = (blockIdx.x % nblk) * MAXG, GB = min(MAXG, G - g0);
  const int length = lengths ? lengths[b] : len_scalar;
  const int lo = window > 0 ? max(length - window, 0) : 0;
  const size_t row0 = (size_t)(b * Hkv + h) * S;  // first row of this head
  const uint32_t* kb = reinterpret_cast<const uint32_t*>(k) + row0 * WPR;
  const uint32_t* vb = reinterpret_cast<const uint32_t*>(v) + row0 * WPR;

  const size_t q0 = ((size_t)b * Hq + h * G + g0) * D;
  for (int i = tid; i < GB * D; i += THREADS)
    qs[i / D][i % D] = __bfloat162float(q[q0 + i]);
  if (tid < MAXG) {
    m_s[tid] = tce::NEG_INF;
    l_s[tid] = 0.f;
  }
  constexpr int NACC = MAXG * D / THREADS;
  float acc[NACC];
#pragma unroll
  for (int r = 0; r < NACC; ++r) acc[r] = 0.f;
  __syncthreads();

  for (int t0 = lo; t0 < length; t0 += T) {
    const int nt = min(T, length - t0);
    for (int i = tid; i < T * WPR; i += THREADS) {
      const int r = i / WPR, c = i % WPR;
      uint32_t kw = 0u, vw = 0u;
      if (r < nt) {
        kw = kb[(size_t)(t0 + r) * WPR + c];
        vw = vb[(size_t)(t0 + r) * WPR + c];
      }
      St::stage(kw, &ks[r][c * St::kPerWord / 2]);
      St::stage(vw, &vs[r][c * St::kPerWord / 2]);
    }
    if (St::kInt8 && tid < T) {
      ksc[tid] = tid < nt ? k_scale[row0 + t0 + tid] : 0.f;
      vsc[tid] = tid < nt ? v_scale[row0 + t0 + tid] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < GB * T; i += THREADS) {
      const int g = i / T, t = i % T;
      float dot = 0.f;
#pragma unroll 8
      for (int c = 0; c < D / 2; ++c) {
        const float2 kf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&ks[t][c]));
        dot = fmaf(qs[g][2 * c], kf.x, dot);
        dot = fmaf(qs[g][2 * c + 1], kf.y, dot);
      }
      const float s = St::kInt8 ? tce::scaled_score(dot, sm_scale, ksc[t])
                                : dot * sm_scale;
      ss[g][t] = t < nt ? s : tce::NEG_INF;
    }
    __syncthreads();
    for (int g = warp; g < GB; g += THREADS / 32) {
      const float s0 = ss[g][lane], s1 = ss[g][lane + 32];
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, tce::warp_max(fmaxf(s0, s1)));
      const float p0 = lane < nt ? expf(s0 - m_new) : 0.f;
      const float p1 = lane + 32 < nt ? expf(s1 - m_new) : 0.f;
      const float psum = tce::warp_sum(p0 + p1);  // l: unscaled
      if (St::kInt8) {
        ss[g][lane] = tce::round_bf16(__fmul_rn(p0, vsc[lane]));
        ss[g][lane + 32] = tce::round_bf16(__fmul_rn(p1, vsc[lane + 32]));
      } else {
        ss[g][lane] = tce::round_bf16(p0);
        ss[g][lane + 32] = tce::round_bf16(p1);
      }
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[g] = l_s[g] * alpha + psum;
        m_s[g] = m_new;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < NACC; ++r) {
      const int i = tid + THREADS * r;
      if (i < GB * D) {
        const int g = i / D, d = i % D;
        float a = acc[r] * alpha_s[g];
        for (int t = 0; t < nt; ++t) {
          const __nv_bfloat16 vv =
              reinterpret_cast<const __nv_bfloat16*>(&vs[t][0])[d];
          a = fmaf(ss[g][t], __bfloat162float(vv), a);
        }
        acc[r] = a;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < NACC; ++r) {
    const int i = tid + THREADS * r;
    if (i < GB * D) {
      const int g = i / D;
      const float l = l_s[g];
      out[q0 + i] =
          __float2bfloat16(l > 0.f ? acc[r] / l : 0.f);
    }
  }
}

template <typename KV>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, void* out, int B, int Hq, int Hkv, int S,
           int D, const void* lengths, int len_scalar, int window,
           float sm_scale, void* stream) {
  const int G = Hq / Hkv;
  const dim3 grid(Hkv * ((G + MAXG - 1) / MAXG), B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const KV*>(k);
  const auto* vp = static_cast<const KV*>(v);
  const auto* ksp = static_cast<const float*>(k_scale);
  const auto* vsp = static_cast<const float*>(v_scale);
  auto* op = static_cast<__nv_bfloat16*>(out);
  const int* lp = static_cast<const int*>(lengths);
  if (D == 64)
    flash_decode_kernel<64, KV><<<grid, THREADS, 0, st>>>(
        qp, kp, vp, ksp, vsp, op, Hq, Hkv, S, lp, len_scalar, window,
        sm_scale);
  else if (D == 128)
    flash_decode_kernel<128, KV><<<grid, THREADS, 0, st>>>(
        qp, kp, vp, ksp, vsp, op, Hq, Hkv, S, lp, len_scalar, window,
        sm_scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, Hq, D] bf16; k, v: one layer [B, Hkv, S, D] bf16; out [B, Hq, D]
// bf16. lengths: device int32 [B], or null to use len_scalar for every b.
// window <= 0: no sliding window. Needs D in {64, 128}, Hq % Hkv == 0.
extern "C" int tce_flash_decode(const void* q, const void* k, const void* v,
                                void* out, int B, int Hq, int Hkv, int S,
                                int D, const void* lengths, int len_scalar,
                                int window, float sm_scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, nullptr, nullptr, out, B, Hq, Hkv,
                               S, D, lengths, len_scalar, window, sm_scale,
                               stream);
}

// The int8 cache: k, v one layer [B, Hkv, S, D] int8 codes; k_scale,
// v_scale that layer's [B, Hkv, S] f32 scales. The rest as above.
extern "C" int tce_flash_decode_s8(const void* q, const void* k,
                                   const void* v, const void* k_scale,
                                   const void* v_scale, void* out, int B,
                                   int Hq, int Hkv, int S, int D,
                                   const void* lengths, int len_scalar,
                                   int window, float sm_scale, void* stream) {
  return launch<int8_t>(q, k, v, k_scale, v_scale, out, B, Hq, Hkv, S, D,
                        lengths, len_scalar, window, sm_scale, stream);
}
