// Causal attention for a prompt chunk against the layer-stacked KV cache,
// bf16 or int8, both products on the tensor cores.
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
// valid prefix and never give NaN; a row with no allowed key gives zeros.
// start/length are per batch row (device int32 [B]) or one scalar. The TPU
// kernel's cast points (_flash_update): scores in f32 from bf16 q and k,
// times sm_scale; masked scores at -1e30; the running max, alpha and exp in
// f32; l summed over the unrounded probabilities; the probabilities rounded
// to bf16 before the PV product, accumulated in f32; out = bf16(acc / l).
// With int8 codes, the TPU kernel's quantized branch: s = (q . code_k) *
// sm_scale * k_scale[col] (two roundings), max and l over the unscaled
// probabilities, p * v_scale[col] rounded to bf16 against the exact codes
// of V (an int8 code is exact in bf16). Output [B, S, Hq * D] bf16.
//
// Bound on the H100: operations. A 2048-token chunk does 4 * S^2 / 2 * D
// per head (34.4 GFLOP at Hq = 32, D = 128) against 2 * Hkv * S * D * 2
// bytes of K/V: far past the bf16 ridge (~295 FLOP per byte), so the work
// has to run on the tensor cores. The design is FlashAttention-2's:
// - One block per (query head, 64-row query tile, batch row), the grid
//   ordered so the tiles with the most keys start first; four warps, each
//   owning 16 query rows, so a row's softmax never leaves its warp.
// - Both products are mma.sync.m16n8k16 (bf16 in, f32 accumulate). Q's
//   fragments are loaded once with ldmatrix and stay in registers; K's
//   come by ldmatrix, V's by ldmatrix.trans, a k-step's fragments loaded
//   together ahead of its MMAs. The S = Q K^T accumulator of an m16n8 tile
//   is laid out as the A operand of the next product, so the probabilities
//   go from the score registers, through the bf16 rounding, straight into
//   PV: no shared-memory round trip. mma.sync and not wgmma: wgmma wants
//   its 64-row A from one warpgroup with the softmax's row statistics
//   spread over four warps, and P would have to go back through shared
//   memory (or be kept in wgmma's layout across warps); mma.sync keeps
//   every row in one warp.
// - K/V tiles of 64 keys come by 16-byte cp.async into a two-stage ring:
//   tile i + 1 is requested right after the barrier that opens tile i, so it
//   loads while tile i multiplies, and one barrier a tile suffices (bf16).
//   Rows are padded by 16 bytes so the eight rows of each ldmatrix phase
//   fall in distinct banks; keys at or past the tile range's end are
//   zero-filled by the copy. The Q tile lives in the ring's last stage (or,
//   int8, in the converted pair) until the fragments are read, and stages
//   the output at the end. The int8 variant copies codes (half the bytes)
//   and the tile's 64 K and V scales, then converts the codes to one padded
//   bf16 tile pair (exact: a byte permute and a float add a code), the way
//   int4_matmul's tile route dequantizes into shared tiles.
// - The block visits only the tiles that hold an allowed key of one of
//   its rows (from the window's lower bound to min(length, last qpos +
//   1)); each warp then skips the tiles that hold no allowed key of its
//   rows, and runs the tiles wholly inside the allowed region of all its
//   rows without the mask arithmetic. Masked columns enter with p = 0, so
//   a row's first tiles, if wholly masked for it, leave no trace (the TPU
//   kernel's -1e30 scores give the same sums once a real key arrives).
// - l is kept per thread over its columns and summed over the row's four
//   lanes at the end (the same sum in another order).
// - The warps are latency-bound (one or two a scheduler). A grid of more
//   than two blocks an SM runs the wide variant: three blocks an SM,
//   registers capped at 168, and the sums' rescale skipped where no row's
//   max moved; a smaller grid (a short chunk over a long prefix, a
//   long-context chunk) runs two blocks an SM with the registers uncapped,
//   faster per block.
// A (b, KV head) block serving its G query heads was left out: a layer's
// K/V (8 MB at S = 2048 for llama3_8b) stays in the 50 MB L2, so the G
// re-reads of a tile come from L2, not from device memory.

#include "common.cuh"

namespace {

constexpr int BK = 64;       // keys per tile
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;

constexpr int BQ = 16 * WARPS;  // query rows per block, 16 per warp
constexpr int STAGES = 2;       // K/V ring (three measured no faster)

// shared memory: a ring of STAGES K/V stages (bf16 K and V tiles, or raw
// int8 codes plus the scales) and, for int8, one converted bf16 tile pair.
// The Q tile is needed only to load the warps' Q fragments and, at the end,
// to stage the output: it lives in the last stage (bf16) or in the
// converted pair (int8), which are first written after the fragments are
// read.
template <int D, typename KV>
struct Tiles {
  static constexpr bool kInt8 = tce::KVStore<KV>::kInt8;
  static constexpr int RS = D + 8;      // padded bf16 row (elements)
  static constexpr int TILE = BK * RS;  // bf16 elements of one K or V tile
  static constexpr int STAGE_BYTES =
      kInt8 ? 2 * BK * D + 2 * BK * 4 : 2 * TILE * 2;
  static constexpr int CONV = STAGES * STAGE_BYTES;  // int8: bf16 pair
  static constexpr int Q = kInt8 ? CONV : (STAGES - 1) * STAGE_BYTES;
  static constexpr int BYTES = CONV + (kInt8 ? 2 * TILE * 2 : 0);
  static_assert(BQ * RS * 2 <= (kInt8 ? 2 * TILE * 2 : STAGE_BYTES),
                "the Q tile fits where it is kept");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !pred
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0));
}

// 4 bytes, or 4 zero bytes when !pred
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Two of the four int8 codes of a word (bytes 0-1 or 2-3) as a bf16 pair,
// exactly: each code c goes, as c + 128, into the low byte of the float
// 2^23 + (c + 128) by a byte permute, 2^23 + 128 is subtracted (exact), and
// the integer rounds to itself in bf16. Full-rate permutes and adds in place
// of integer-to-float conversions.
__device__ __forceinline__ float code_at(uint32_t u, int byte) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + byte))
         - 8388736.f;
}
__device__ __forceinline__ uint32_t codes_lo(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  return pack_bf16(code_at(u, 0), code_at(u, 1));
}
__device__ __forceinline__ uint32_t codes_hi(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  return pack_bf16(code_at(u, 2), code_at(u, 3));
}

// One tile of keys [t0, t0 + BK) into a ring stage: bf16 K then V padded
// tiles, or int8 K then V codes [BK][D] and the K then V scales [BK]. Keys
// at or past `end` are zero-filled.
template <int D, typename KV>
__device__ __forceinline__ void load_tile(uint8_t* stage, const KV* kb,
                                          const KV* vb, const float* ksb,
                                          const float* vsb, int t0, int end) {
  using Ti = Tiles<D, KV>;
  constexpr int PER16 = 16 / sizeof(KV);  // elements in a 16-byte copy
  constexpr int CPR = D / PER16;          // copies per row
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = tid; i < BK * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR;
    const bool in = t0 + r < end;
    const size_t src = (size_t)(in ? t0 + r : 0) * D + c * PER16;
    if constexpr (Ti::kInt8) {
      cp_async16(smem_u32(stage + r * D + c * 16), kb + src, in);
      cp_async16(smem_u32(stage + BK * D + r * D + c * 16), vb + src, in);
    } else {
      auto* kt = reinterpret_cast<__nv_bfloat16*>(stage);
      cp_async16(smem_u32(kt + r * Ti::RS + c * 8), kb + src, in);
      cp_async16(smem_u32(kt + Ti::TILE + r * Ti::RS + c * 8), vb + src, in);
    }
  }
  if constexpr (Ti::kInt8) {
    if (tid < 2 * BK) {
      const int r = tid % BK;
      const bool in = t0 + r < end;
      const float* src = (tid < BK ? ksb : vsb) + (in ? t0 + r : 0);
      cp_async4(smem_u32(stage + 2 * BK * D + tid * 4), src, in);
    }
  }
}

// WIDE: three blocks an SM (registers capped at 168) for grids that fill
// the card, two otherwise (up to 255 registers, faster per block)
template <int D, typename KV, bool WIDE>
__global__ void __launch_bounds__(THREADS, WIDE ? 3 : 2) flash_prefill_kernel(
    const __nv_bfloat16* __restrict__ q, const KV* __restrict__ k,
    const KV* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, __nv_bfloat16* __restrict__ out,
    int S, int Hq, int Hkv, int Smax, const int* __restrict__ starts,
    int start_scalar, const int* __restrict__ lengths, int len_scalar,
    int window, float sm_scale) {
  using Ti = Tiles<D, KV>;
  constexpr int RS = Ti::RS;
  constexpr int KS = D / 16;   // k-steps of the score product
  constexpr int NO = D / 8;    // n-tiles of the output
  extern __shared__ __align__(128) uint8_t smem[];
  auto* qs = reinterpret_cast<__nv_bfloat16*>(smem + Ti::Q);
  auto* conv = reinterpret_cast<__nv_bfloat16*>(smem + Ti::CONV);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row group, column pair
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest tiles first
  const int hk = h / (Hq / Hkv);
  const int start = starts ? starts[b] : start_scalar;
  const int length = lengths ? lengths[b] : len_scalar;

  // keys some row of the block may see: [lo, end)
  const int end = min(length, start + min(q0 + BQ, S));
  int lo = window > 0 ? max(start + q0 - window + 1, 0) : 0;
  lo = (lo / BK) * BK;
  const int n_tiles = end > lo ? (end - lo + BK - 1) / BK : 0;

  const size_t row0 = (size_t)(b * Hkv + hk) * Smax;  // this head's row 0
  const KV* kb = k + row0 * D;
  const KV* vb = v + row0 * D;
  const float* ksb = Ti::kInt8 ? k_scale + row0 : nullptr;
  const float* vsb = Ti::kInt8 ? v_scale + row0 : nullptr;

  // the Q tile (rows past S zero-filled) with tile 0, then tiles up to
  // STAGES - 2, one commit group each
  for (int i = tid; i < BQ * (D / 8); i += THREADS) {
    const int r = i / (D / 8), c = i % (D / 8);
    const bool in = q0 + r < S;
    cp_async16(smem_u32(qs + r * RS + c * 8),
               q + (((size_t)b * S + (in ? q0 + r : 0)) * Hq + h) * D + c * 8,
               in);
  }
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < n_tiles)
      load_tile<D, KV>(smem + j * Ti::STAGE_BYTES, kb, vb, ksb, vsb,
                       lo + j * BK, end);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();  // Q and tile 0
  __syncthreads();

  // this warp's 16 query rows: positions qa..qa+15, the last real one qz;
  // its Q fragments stay in registers
  const int qa = start + q0 + 16 * warp;
  const int qz = min(qa + 15, start + S - 1);
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldmatrix_x4(qf[kk], smem_u32(qs + (16 * warp + lane % 16) * RS + 16 * kk
                                 + (lane / 16) * 8));
  __syncthreads();  // every warp holds its fragments: the Q tile is free

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {tce::NEG_INF, tce::NEG_INF}, l[2] = {0.f, 0.f};

  // the columns no row of the warp allows past, and those all its rows do
  const int any_hi = min(qz + 1, length), all_hi = min(qa + 1, length);

  for (int i = 0; i < n_tiles; ++i) {
    const int t0 = lo + i * BK;
    if (i > 0) {
      cp_async_wait<STAGES - 2>();  // tile i has landed
      __syncthreads();  // and every warp is done with tile i - 1
    }
    // tile i + STAGES - 1 into the stage tile i - 1 held
    if (i + STAGES - 1 < n_tiles)
      load_tile<D, KV>(smem + ((i + STAGES - 1) % STAGES) * Ti::STAGE_BYTES,
                       kb, vb, ksb, vsb, t0 + (STAGES - 1) * BK, end);
    cp_async_commit();
    const uint8_t* stage = smem + (i % STAGES) * Ti::STAGE_BYTES;
    const __nv_bfloat16* kt;
    const float *ksc = nullptr, *vsc = nullptr;
    if constexpr (Ti::kInt8) {
      // codes -> padded bf16 tiles (exact), 16 codes a copy
      for (int j = tid; j < 2 * BK * (D / 16); j += THREADS) {
        const int kv = j / (BK * (D / 16)), r = (j / (D / 16)) % BK,
                  c = j % (D / 16);
        const uint4 w = *reinterpret_cast<const uint4*>(
            stage + kv * BK * D + r * D + c * 16);
        uint4* dst = reinterpret_cast<uint4*>(conv + kv * Ti::TILE + r * RS
                                              + c * 16);
        dst[0] = make_uint4(codes_lo(w.x), codes_hi(w.x), codes_lo(w.y),
                            codes_hi(w.y));
        dst[1] = make_uint4(codes_lo(w.z), codes_hi(w.z), codes_lo(w.w),
                            codes_hi(w.w));
      }
      ksc = reinterpret_cast<const float*>(stage + 2 * BK * D);
      vsc = ksc + BK;
      __syncthreads();
      kt = conv;
    } else {
      kt = reinterpret_cast<const __nv_bfloat16*>(stage);
    }
    const __nv_bfloat16* vt = kt + Ti::TILE;

    const bool skip = qa > qz || t0 >= any_hi
                      || (window > 0 && t0 + BK - 1 <= qa - window);
    const bool full = t0 + BK <= all_hi && (window <= 0 || t0 > qz - window);
    if (skip) continue;
    // S = Q K^T: 8 n-tiles of 8 keys
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    // K fragments of k-step kk, all four key pairs (16 keys each)
    const uint32_t kaddr = smem_u32(kt + ((lane / 16) * 8 + lane % 8) * RS
                                    + ((lane / 8) % 2) * 8);
    {
      uint32_t kf[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int j = 0; j < BK / 16; ++j)
          ldmatrix_x4(kf[j], kaddr + (16 * j * RS + 16 * kk) * 2);
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          mma_bf16(s[2 * j], qf[kk], kf[j][0], kf[j][1]);
          mma_bf16(s[2 * j + 1], qf[kk], kf[j][2], kf[j][3]);
        }
      }
    }

    // scale, mask, the rows' new maxima (rows g and g + 8)
    float mx[2] = {tce::NEG_INF, tce::NEG_INF};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t + (e & 1);
        float x = Ti::kInt8 ? tce::scaled_score(s[n][e], sm_scale, ksc[c])
                            : s[n][e] * sm_scale;
        if (!full) {
          const int qpos = qa + g + 8 * (e >> 1), col = t0 + c;
          const bool ok = col < min(qpos + 1, length)
                          && (window <= 0 || col > qpos - window);
          x = ok ? x : tce::NEG_INF;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    // p = exp(s - m) (0 where masked); l over the unrounded p; the A
    // fragments of PV from the rounded p (x v_scale for int8)
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[n][e];
        p[e] = (full || x != tce::NEG_INF) ? expf(x - m[e >> 1]) : 0.f;
        l[e >> 1] += p[e];
        if constexpr (Ti::kInt8)
          p[e] = __fmul_rn(p[e], vsc[8 * n + 2 * t + (e & 1)]);
      }
      pa[n / 2][(n % 2) * 2] = pack_bf16(p[0], p[1]);
      pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
    // rescale the sums; the wide variant skips it where no row of the warp
    // has a new max (x 1.0f is exact, so skipping changes no bit)
    if (!WIDE || !__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
    }
    // O += P V
    const uint32_t vaddr = smem_u32(vt + (((lane / 8) % 2) * 8 + lane % 8) * RS
                                    + (lane / 16) * 8);
    // in steps of four d-pairs (32 output columns) of one 16-key slice
    constexpr int GJ = D / 16 < 4 ? D / 16 : 4;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int j0 = 0; j0 < D / 16; j0 += GJ) {
        uint32_t vf[GJ][4];
#pragma unroll
        for (int x = 0; x < GJ; ++x)
          ldmatrix_x4_trans(vf[x], vaddr + (16 * kk * RS + 16 * (j0 + x)) * 2);
#pragma unroll
        for (int x = 0; x < GJ; ++x) {
          mma_bf16(o[2 * (j0 + x)], pa[kk], vf[x][0], vf[x][1]);
          mma_bf16(o[2 * (j0 + x) + 1], pa[kk], vf[x][2], vf[x][3]);
        }
      }
    }
  }

  // l over the row's four lanes; out = bf16(acc / l), zeros with no key;
  // staged through this warp's rows of the Q tile once every warp is done
  // with the last tile, then 16 bytes a lane to the output
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    den[r] = l[r] > 0.f ? l[r] : 1.f;  // l == 0 only with no allowed key
  }
  __syncthreads();
  __nv_bfloat16* ow = qs + 16 * warp * RS;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<uint32_t*>(ow + g * RS + 8 * n + 2 * t) =
        pack_bf16(o[n][0] / den[0], o[n][1] / den[0]);
    *reinterpret_cast<uint32_t*>(ow + (g + 8) * RS + 8 * n + 2 * t) =
        pack_bf16(o[n][2] / den[1], o[n][3] / den[1]);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * (D / 8); i += 32) {
    const int r = i / (D / 8), c = i % (D / 8);
    const int row = q0 + 16 * warp + r;
    if (row < S)
      *reinterpret_cast<uint4*>(out + (((size_t)b * S + row) * Hq + h) * D
                                + c * 8) =
          *reinterpret_cast<const uint4*>(ow + r * RS + c * 8);
  }
}

struct Launch {
  const void *q, *k, *v, *k_scale, *v_scale;
  void* out;
  int B, S, Hq, Hkv, Smax, D;
  const void* starts;
  int start_scalar;
  const void* lengths;
  int len_scalar, window;
  float sm_scale;
  cudaStream_t st;
};

template <int D, typename KV, bool WIDE>
int launch_d(const Launch& a) {
  constexpr int bytes = Tiles<D, KV>::BYTES;
  static bool configured = false;  // once, outside any CUDA graph capture
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_kernel<D, KV, WIDE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid(a.Hq, (a.S + BQ - 1) / BQ, a.B);
  flash_prefill_kernel<D, KV, WIDE><<<grid, THREADS, bytes, a.st>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale),
      static_cast<__nv_bfloat16*>(a.out), a.S, a.Hq, a.Hkv, a.Smax,
      static_cast<const int*>(a.starts), a.start_scalar,
      static_cast<const int*>(a.lengths), a.len_scalar, a.window,
      a.sm_scale);
  return (int)cudaGetLastError();
}

// the wide variant where the grid holds more than two blocks an SM
template <int D, typename KV>
int launch_dim(const Launch& a) {
  static int sms = 0;  // once, outside any CUDA graph capture
  if (!sms) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const long blocks = (long)a.Hq * ((a.S + BQ - 1) / BQ) * a.B;
  return blocks > 2L * sms ? launch_d<D, KV, true>(a)
                           : launch_d<D, KV, false>(a);
}

template <typename KV>
int launch(const Launch& a) {
  if (a.D == 64) return launch_dim<64, KV>(a);
  if (a.D == 128) return launch_dim<128, KV>(a);
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
  return launch<__nv_bfloat16>(
      {q, k, v, nullptr, nullptr, out, B, S, Hq, Hkv, Smax, D, starts,
       start_scalar, lengths, len_scalar, window, sm_scale,
       static_cast<cudaStream_t>(stream)});
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
  return launch<int8_t>(
      {q, k, v, k_scale, v_scale, out, B, S, Hq, Hkv, Smax, D, starts,
       start_scalar, lengths, len_scalar, window, sm_scale,
       static_cast<cudaStream_t>(stream)});
}
