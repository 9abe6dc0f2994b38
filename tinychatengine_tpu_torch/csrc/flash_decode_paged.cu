// Single-token attention over a paged KV cache (continuous-batching
// serving), bf16 or int8 pages.
//
// Replaces: tinychatengine_tpu/ops/attention.py · flash_decode_paged
// (body _paged_decode_kernel, pallas_call site :366), both of its branches.
//
// q [B, Hq, D] bf16 against one layer of the page pool, k/v
// [n_pages, Hkv, P, D] (the wrapper offsets the pointers to the layer):
// bf16 values, or int8 codes with f32 scales [n_pages, Hkv, P]. Key pos of
// row b lives in page table[b, pos / P] at offset pos % P. Keys at lo <=
// pos < lengths[b] take part, lo = max(length - window, 0) with a sliding
// window, else 0. Online softmax in fp32; the probabilities are rounded to
// bf16 before the PV product while the running sum l takes the unrounded
// values (the TPU kernel's _flash_update); int8 codes take the TPU
// kernel's quantized branch as csrc/flash_decode.cu describes. A row of
// length 0 gives zeros.
//
// Bound on the H100: bytes (the valid K/V rows, 2 * length * D * 2 bytes
// per (b, kv head) in bf16, 2 * length * (D + 4) in int8). The design is
// csrc/flash_decode.cu's: one block per (b, kv head, group of up to 8
// query heads of that KV head), 64-key tiles staged into shared memory as
// bf16 pairs (int8 codes converted as they are staged, their scales beside
// them), visited from lo in steps of 64. Only the
// address of each key row differs: before a tile is loaded, its 64 row
// indices are resolved through the page table into shared memory, so P
// need not divide 64 (nor 64 divide P) and no table entry past
// ceil(length / P) is read. With the same tile order and arithmetic as
// flash_decode, paged and dense decode of the same K/V give bit-identical
// outputs, in both storages.

#include "common.cuh"

namespace {

constexpr int T = 64;        // keys per tile
constexpr int THREADS = 128;
constexpr int MAXG = 8;      // query heads per KV head

template <int D, typename KV>
__global__ void __launch_bounds__(THREADS) flash_decode_paged_kernel(
    const __nv_bfloat16* __restrict__ q, const KV* __restrict__ k,
    const KV* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, __nv_bfloat16* __restrict__ out,
    int Hq, int Hkv, int P, const int* __restrict__ table, int max_pages,
    const int* __restrict__ lengths, int len_scalar, int window,
    float sm_scale) {
  using St = tce::KVStore<KV>;
  constexpr int WPR = D / St::kPerWord;  // device words per K/V row
  constexpr int DW = D / 2 + 1;  // staged bf16 row, padded, in 32-bit words
  __shared__ float qs[MAXG][D];
  __shared__ uint32_t ks[T][DW];
  __shared__ uint32_t vs[T][DW];
  __shared__ float ksc[St::kInt8 ? T : 1], vsc[St::kInt8 ? T : 1];
  __shared__ float ss[MAXG][T];
  __shared__ float m_s[MAXG], l_s[MAXG], alpha_s[MAXG];
  __shared__ size_t row_idx[T];  // pool row (page, head, offset) of a key

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // block x = (kv head h, group block): up to MAXG of the G query heads
  // that share KV head h (MQA's G = 48 takes six blocks per head)
  const int G = Hq / Hkv, nblk = (G + MAXG - 1) / MAXG;
  const int h = blockIdx.x / nblk, b = blockIdx.y;
  const int g0 = (blockIdx.x % nblk) * MAXG, GB = min(MAXG, G - g0);
  const int length = lengths ? lengths[b] : len_scalar;
  const int lo = window > 0 ? max(length - window, 0) : 0;
  const int* tb = table + (size_t)b * max_pages;
  const uint32_t* kb = reinterpret_cast<const uint32_t*>(k);
  const uint32_t* vb = reinterpret_cast<const uint32_t*>(v);

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
    if (tid < nt) {
      const int pos = t0 + tid;
      const size_t page = (size_t)tb[pos / P];
      row_idx[tid] = (page * Hkv + h) * P + pos % P;
    }
    __syncthreads();
    for (int i = tid; i < T * WPR; i += THREADS) {
      const int r = i / WPR, c = i % WPR;
      uint32_t kw = 0u, vw = 0u;
      if (r < nt) {
        kw = kb[row_idx[r] * WPR + c];
        vw = vb[row_idx[r] * WPR + c];
      }
      St::stage(kw, &ks[r][c * St::kPerWord / 2]);
      St::stage(vw, &vs[r][c * St::kPerWord / 2]);
    }
    if (St::kInt8 && tid < T) {
      ksc[tid] = tid < nt ? k_scale[row_idx[tid]] : 0.f;
      vsc[tid] = tid < nt ? v_scale[row_idx[tid]] : 0.f;
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
           const void* v_scale, void* out, int B, int Hq, int Hkv, int P,
           int D, const void* table, int max_pages, const void* lengths,
           int len_scalar, int window, float sm_scale, void* stream) {
  const int G = Hq / Hkv;
  const dim3 grid(Hkv * ((G + MAXG - 1) / MAXG), B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const KV*>(k);
  const auto* vp = static_cast<const KV*>(v);
  const auto* ksp = static_cast<const float*>(k_scale);
  const auto* vsp = static_cast<const float*>(v_scale);
  auto* op = static_cast<__nv_bfloat16*>(out);
  const int* tp = static_cast<const int*>(table);
  const int* lp = static_cast<const int*>(lengths);
  if (D == 64)
    flash_decode_paged_kernel<64, KV><<<grid, THREADS, 0, st>>>(
        qp, kp, vp, ksp, vsp, op, Hq, Hkv, P, tp, max_pages, lp, len_scalar,
        window, sm_scale);
  else if (D == 128)
    flash_decode_paged_kernel<128, KV><<<grid, THREADS, 0, st>>>(
        qp, kp, vp, ksp, vsp, op, Hq, Hkv, P, tp, max_pages, lp, len_scalar,
        window, sm_scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, Hq, D] bf16; k, v: one layer's pages [n_pages, Hkv, P, D] bf16;
// table [B, max_pages] int32 page ids; out [B, Hq, D] bf16. lengths:
// device int32 [B], or null to use len_scalar for every b. window <= 0: no
// sliding window. Needs D in {64, 128}, Hq % Hkv == 0.
extern "C" int tce_flash_decode_paged(const void* q, const void* k,
                                      const void* v, void* out, int B, int Hq,
                                      int Hkv, int P, int D, const void* table,
                                      int max_pages, const void* lengths,
                                      int len_scalar, int window,
                                      float sm_scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, nullptr, nullptr, out, B, Hq, Hkv,
                               P, D, table, max_pages, lengths, len_scalar,
                               window, sm_scale, stream);
}

// int8 pages: k, v one layer's [n_pages, Hkv, P, D] int8 codes; k_scale,
// v_scale that layer's [n_pages, Hkv, P] f32 scales. The rest as above.
extern "C" int tce_flash_decode_paged_s8(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, void* out, int B, int Hq, int Hkv, int P, int D,
    const void* table, int max_pages, const void* lengths, int len_scalar,
    int window, float sm_scale, void* stream) {
  return launch<int8_t>(q, k, v, k_scale, v_scale, out, B, Hq, Hkv, P, D,
                        table, max_pages, lengths, len_scalar, window,
                        sm_scale, stream);
}
