// Causal attention for a prompt chunk against the layer-stacked KV cache,
// bf16 or int8.
//
// Replaces: tinychatengine_tpu/ops/attention.py · flash_prefill
// (body _prefill_kernel, pallas_call site :538), both of its branches.
//
// q [B, S, Hq, D] bf16 at positions start..start+S-1, read in place (no
// transpose); k/v: one layer [B, Hkv, S_max, D] (the wrapper offsets the
// pointers to the layer) that already holds the chunk: bf16 values, or
// int8 codes with f32 scales [B, Hkv, S_max]. Key col is allowed for query
// position qpos iff col < min(qpos + 1, length) and, with a sliding window,
// col > qpos - window — so rows past the true length attend to the whole
// valid prefix and never give NaN. start/length are per batch row (device
// int32 [B]) or one scalar. Online softmax in fp32, probabilities rounded
// to bf16 before the PV product while the running sum l takes the
// unrounded values (the TPU kernel's _flash_update), masked scores at the
// same finite -1e30. With int8 codes, the TPU kernel's quantized branch:
// s = (q . code_k) * sm_scale * k_scale[col] (two roundings), max and l
// over the unscaled probabilities, p * v_scale[col] rounded to bf16 against
// the exact V codes. Output [B, S, Hq * D] bf16.
//
// Bound on the H100: at a 2048-token chunk the work is bound by operations
// (4 * S^2/2 * D per head against reading K/V once), far above the bytes.
// This first version runs the two products on the CUDA cores in fp32, under
// the bf16 tensor-core peak. Design: one block per (64-row query tile,
// query head, batch row); 128 threads as a 16 x 8 grid, each owning 4 rows
// x 8 key columns of the 64 x 64 score tile and 4 rows x D/8 output
// columns. Q, K and V tiles sit in shared memory as bf16 pairs with rows
// padded by one word (conflict-free column reads); an int8 tile reads half
// the bytes from device memory and is converted to bf16 as it is staged
// (exact for the codes; tce::KVStore), its 64 scales beside it. The key
// loop visits only tiles that hold an allowed key of some row of the block
// (from the window's lower bound to min(length, last qpos + 1)). The row
// max and sum reduce over the 8 lanes that share a row with shuffles.
// Later work: mma/wgmma tensor-core tiles and a (b, kv head) block for GQA
// reuse.

#include "common.cuh"

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int THREADS = 128; // 16 x 8
constexpr int PS = BK + 8;   // probability row stride (conflict-free)

template <int D, typename KV>
constexpr int smem_bytes() {
  return (BQ + 2 * BK) * (D / 2 + 1) * 4 + BQ * PS * 4
         + (tce::KVStore<KV>::kInt8 ? 2 * BK * 4 : 0);
}

template <int D, typename KV>
__global__ void __launch_bounds__(THREADS) flash_prefill_kernel(
    const __nv_bfloat16* __restrict__ q, const KV* __restrict__ k,
    const KV* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, __nv_bfloat16* __restrict__ out,
    int S, int Hq, int Hkv, int Smax, const int* __restrict__ starts,
    int start_scalar, const int* __restrict__ lengths, int len_scalar,
    int window, float sm_scale) {
  using St = tce::KVStore<KV>;
  constexpr int WPR = D / St::kPerWord;  // device words per K/V row
  constexpr int DW = D / 2 + 1;  // padded bf16 row length in 32-bit words
  constexpr int NJ = D / 16;     // output word columns per thread
  extern __shared__ uint32_t smem[];
  uint32_t* qs = smem;            // [BQ][DW]
  uint32_t* ks = qs + BQ * DW;    // [BK][DW]
  uint32_t* vs = ks + BK * DW;    // [BK][DW]
  float* ps = reinterpret_cast<float*>(vs + BK * DW);  // [BQ][PS]
  float* ksc = ps + BQ * PS;      // [BK] (int8 only)
  float* vsc = ksc + BK;          // [BK]

  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int start = starts ? starts[b] : start_scalar;
  const int length = lengths ? lengths[b] : len_scalar;

  for (int i = tid; i < BQ * (D / 2); i += THREADS) {
    const int r = i / (D / 2), c = i % (D / 2);
    uint32_t w = 0u;
    if (q0 + r < S)
      w = reinterpret_cast<const uint32_t*>(
          q + (((size_t)b * S + q0 + r) * Hq + h) * D)[c];
    qs[r * DW + c] = w;
  }

  float m[4], l[4], acc[4][2 * NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = tce::NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * NJ; ++j) acc[i][j] = 0.f;
  }

  const int needed = min(length, start + q0 + BQ);
  int lo = window > 0 ? max(start + q0 - window + 1, 0) : 0;
  lo = (lo / BK) * BK;
  const size_t row0 = (size_t)(b * Hkv + hk) * Smax;  // this head's row 0
  const uint32_t* kb = reinterpret_cast<const uint32_t*>(k) + row0 * WPR;
  const uint32_t* vb = reinterpret_cast<const uint32_t*>(v) + row0 * WPR;

  for (int t0 = lo; t0 < needed; t0 += BK) {
    __syncthreads();  // q tile stored / previous tile's readers done
    for (int i = tid; i < BK * WPR; i += THREADS) {
      const int r = i / WPR, c = i % WPR;
      uint32_t kw = 0u, vw = 0u;
      if (t0 + r < needed) {
        kw = kb[(size_t)(t0 + r) * WPR + c];
        vw = vb[(size_t)(t0 + r) * WPR + c];
      }
      St::stage(kw, &ks[r * DW + c * St::kPerWord / 2]);
      St::stage(vw, &vs[r * DW + c * St::kPerWord / 2]);
    }
    if (St::kInt8 && tid < BK) {
      const bool in = t0 + tid < needed;
      ksc[tid] = in ? k_scale[row0 + t0 + tid] : 0.f;
      vsc[tid] = in ? v_scale[row0 + t0 + tid] : 0.f;
    }
    __syncthreads();

    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D / 2; ++c) {
      float2 qf[4], kf[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qf[i] = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&qs[(ty + 16 * i) * DW + c]));
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kf[j] = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&ks[(tx + 8 * j) * DW + c]));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sc[i][j] = fmaf(qf[i].x, kf[j].x, sc[i][j]);
          sc[i][j] = fmaf(qf[i].y, kf[j].y, sc[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = start + q0 + r;
      const int limit = min(qpos + 1, length);
      float rmax = tce::NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = t0 + tx + 8 * j;
        const bool ok = col < limit && (window <= 0 || col > qpos - window);
        const float s = St::kInt8
            ? tce::scaled_score(sc[i][j], sm_scale, ksc[tx + 8 * j])
            : sc[i][j] * sm_scale;
        sc[i][j] = ok ? s : tce::NEG_INF;
        rmax = fmaxf(rmax, sc[i][j]);
      }
      rmax = tce::warp_max(rmax, 8);  // the 8 lanes of this row
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(sc[i][j] - m_new);
        psum += p;  // l: unscaled
        ps[r * PS + tx + 8 * j] = tce::round_bf16(
            St::kInt8 ? __fmul_rn(p, vsc[tx + 8 * j]) : p);
      }
      psum = tce::warp_sum(psum, 8);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 2 * NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < BK; ++t) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * PS + t];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float2 vf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&vs[t * DW + tx + 8 * jj]));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][2 * jj] = fmaf(p[i], vf.x, acc[i][2 * jj]);
          acc[i][2 * jj + 1] = fmaf(p[i], vf.y, acc[i][2 * jj + 1]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= S) continue;
    const float li = l[i] > 0.f ? l[i] : 1.f;  // l == 0 only with no key
    __nv_bfloat162* orow = reinterpret_cast<__nv_bfloat162*>(
        out + (((size_t)b * S + q0 + r) * Hq + h) * D);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      orow[tx + 8 * jj] =
          __floats2bfloat162_rn(acc[i][2 * jj] / li, acc[i][2 * jj + 1] / li);
  }
}

template <int D, typename KV>
int launch_d(dim3 grid, cudaStream_t st, const __nv_bfloat16* q,
             const KV* k, const KV* v, const float* k_scale,
             const float* v_scale, __nv_bfloat16* out, int S, int Hq, int Hkv,
             int Smax, const int* starts, int start_scalar,
             const int* lengths, int len_scalar, int window, float sm_scale) {
  constexpr int bytes = smem_bytes<D, KV>();
  static bool configured = false;  // once, outside any CUDA graph capture
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_kernel<D, KV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  flash_prefill_kernel<D, KV><<<grid, THREADS, bytes, st>>>(
      q, k, v, k_scale, v_scale, out, S, Hq, Hkv, Smax, starts, start_scalar,
      lengths, len_scalar, window, sm_scale);
  return (int)cudaGetLastError();
}

template <typename KV>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, void* out, int B, int S, int Hq, int Hkv,
           int Smax, int D, const void* starts, int start_scalar,
           const void* lengths, int len_scalar, int window, float sm_scale,
           void* stream) {
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const KV*>(k);
  const auto* vp = static_cast<const KV*>(v);
  const auto* ksp = static_cast<const float*>(k_scale);
  const auto* vsp = static_cast<const float*>(v_scale);
  auto* op = static_cast<__nv_bfloat16*>(out);
  const int* sp = static_cast<const int*>(starts);
  const int* lp = static_cast<const int*>(lengths);
  if (D == 64)
    return launch_d<64, KV>(grid, st, qp, kp, vp, ksp, vsp, op, S, Hq, Hkv,
                            Smax, sp, start_scalar, lp, len_scalar, window,
                            sm_scale);
  if (D == 128)
    return launch_d<128, KV>(grid, st, qp, kp, vp, ksp, vsp, op, S, Hq, Hkv,
                             Smax, sp, start_scalar, lp, len_scalar, window,
                             sm_scale);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B, S, Hq, D] bf16; k, v: one layer [B, Hkv, Smax, D] bf16;
// out [B, S, Hq * D] bf16. starts / lengths: device int32 [B], or null to
// use the scalar for every b. window <= 0: no sliding window.
// Needs D in {64, 128} and Hq % Hkv == 0.
extern "C" int tce_flash_prefill(const void* q, const void* k, const void* v,
                                 void* out, int B, int S, int Hq, int Hkv,
                                 int Smax, int D, const void* starts,
                                 int start_scalar, const void* lengths,
                                 int len_scalar, int window, float sm_scale,
                                 void* stream) {
  return launch<__nv_bfloat16>(q, k, v, nullptr, nullptr, out, B, S, Hq, Hkv,
                               Smax, D, starts, start_scalar, lengths,
                               len_scalar, window, sm_scale, stream);
}

// The int8 cache: k, v one layer [B, Hkv, Smax, D] int8 codes; k_scale,
// v_scale that layer's [B, Hkv, Smax] f32 scales. The rest as above.
extern "C" int tce_flash_prefill_s8(const void* q, const void* k,
                                    const void* v, const void* k_scale,
                                    const void* v_scale, void* out, int B,
                                    int S, int Hq, int Hkv, int Smax, int D,
                                    const void* starts, int start_scalar,
                                    const void* lengths, int len_scalar,
                                    int window, float sm_scale,
                                    void* stream) {
  return launch<int8_t>(q, k, v, k_scale, v_scale, out, B, S, Hq, Hkv, Smax,
                        D, starts, start_scalar, lengths, len_scalar, window,
                        sm_scale, stream);
}
