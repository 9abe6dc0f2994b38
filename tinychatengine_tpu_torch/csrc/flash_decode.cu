// Single-token attention over the layer-stacked KV cache, bf16 or int8.
//
// Replaces: tinychatengine_tpu/ops/attention.py · flash_decode
// (body _decode_kernel, pallas_call site :194), both of its branches.
//
// q [B, Hq, D] bf16 against one layer of the cache, k/v [B, Hkv, S, D]
// (the wrapper offsets the pointers to the layer): bf16 values, or int8
// codes with f32 scales k_scale/v_scale [B, Hkv, S] (kv_cache_dtype
// "int8"). The body, its arithmetic and its key-range split are
// csrc/flash_decode.cuh's, with the dense row policy (row0 + pos).
//
// Bound on the H100: bytes, the valid K/V prefix: 2 * length * D * 2 bytes
// per (b, kv head) in bf16, 2 * length * (D + 4) with int8 codes and their
// scales. What the split does about it: blocks = B * Hkv * ceil(G / 8) *
// ceil(length / SPLIT), so at SPLIT = 128 llama3_8b's B = 1, Hkv = 8 runs
// 256 blocks over 4095 keys (32 per KV head, each streaming 128 keys), where
// the single-block version ran 8 on the card's 132 SMs; the merge reads back
// D + 2 floats per (head, split), 2 % of the K/V bytes at D = 128.

#include "flash_decode.cuh"

using tce::decode::DenseRows;
using tce::decode::launch;

// q [B, Hq, D] bf16; k, v: one layer [B, Hkv, S, D] bf16; out [B, Hq, D]
// bf16; ws: f32 scratch of B * Hq * n_split * (D + 2). lengths: device
// int32 [B], or null to use len_scalar for every b. window <= 0: no sliding
// window. n_split splits of SPLIT keys must cover every length. Needs D
// in {64, 128}, Hq % Hkv == 0.
extern "C" int tce_flash_decode(const void* q, const void* k, const void* v,
                                void* out, void* ws, int B, int Hq, int Hkv,
                                int S, int D, const void* lengths,
                                int len_scalar, int window, float sm_scale,
                                int n_split, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, nullptr, nullptr, out, ws, B, Hq, Hkv,
                               D, DenseRows{S}, lengths, len_scalar, window,
                               sm_scale, n_split, stream);
}

// The int8 cache: k, v one layer [B, Hkv, S, D] int8 codes; k_scale,
// v_scale that layer's [B, Hkv, S] f32 scales. The rest as above.
extern "C" int tce_flash_decode_s8(const void* q, const void* k,
                                   const void* v, const void* k_scale,
                                   const void* v_scale, void* out, void* ws,
                                   int B, int Hq, int Hkv, int S, int D,
                                   const void* lengths, int len_scalar,
                                   int window, float sm_scale, int n_split,
                                   void* stream) {
  return launch<int8_t>(q, k, v, k_scale, v_scale, out, ws, B, Hq, Hkv, D,
                        DenseRows{S}, lengths, len_scalar, window, sm_scale,
                        n_split, stream);
}
