// Single-token attention over a paged KV cache (continuous-batching
// serving), bf16 or int8 pages.
//
// Replaces: tinychatengine_tpu/ops/attention.py · flash_decode_paged
// (body _paged_decode_kernel, pallas_call site :366), both of its branches.
//
// q [B, Hq, D] bf16 against one layer of the page pool, k/v
// [n_pages, Hkv, P, D] (the wrapper offsets the pointers to the layer):
// bf16 values, or int8 codes with f32 scales [n_pages, Hkv, P]. Key pos of
// row b lives in page table[b, pos / P] at offset pos % P. The body is
// csrc/flash_decode.cuh's with the paged row policy: only the address of a
// key row differs from csrc/flash_decode.cu, resolved through the page
// table for each 64-key tile. The split partition counts key positions
// alone, so paged and dense decode of the same K/V give bit-identical
// outputs in both storages, and a row of length 0 gives zeros.
//
// Bound on the H100: bytes (the valid K/V rows, 2 * length * D * 2 bytes
// per (b, kv head) in bf16, 2 * length * (D + 4) in int8, plus 4 bytes of
// table per page). The split gives B * Hkv * ceil(G / 8) * ceil(length /
// SPLIT) busy blocks: 664 at SPLIT = 128, Hkv = 8 over eight rows of 1 to
// 4607 keys (1, 37, 128, 129, 700, 1500, 3000, 4607), against 64 for the
// single-block version.

#include "flash_decode.cuh"

using tce::decode::launch;
using tce::decode::PagedRows;

// q [B, Hq, D] bf16; k, v: one layer's pages [n_pages, Hkv, P, D] bf16;
// table [B, max_pages] int32 page ids; out [B, Hq, D] bf16; ws: f32
// scratch of B * Hq * n_split * (D + 2). lengths: device int32 [B], or null
// to use len_scalar for every b. window <= 0: no sliding window. n_split
// splits of SPLIT keys must cover every length. Needs D in {64, 128},
// Hq % Hkv == 0.
extern "C" int tce_flash_decode_paged(const void* q, const void* k,
                                      const void* v, void* out, void* ws,
                                      int B, int Hq, int Hkv, int P, int D,
                                      const void* table, int max_pages,
                                      const void* lengths, int len_scalar,
                                      int window, float sm_scale, int n_split,
                                      void* stream) {
  const PagedRows rows{static_cast<const int*>(table), max_pages, P};
  return launch<__nv_bfloat16>(q, k, v, nullptr, nullptr, out, ws, B, Hq, Hkv,
                               D, rows, lengths, len_scalar, window, sm_scale,
                               n_split, stream);
}

// int8 pages: k, v one layer's [n_pages, Hkv, P, D] int8 codes; k_scale,
// v_scale that layer's [n_pages, Hkv, P] f32 scales. The rest as above.
extern "C" int tce_flash_decode_paged_s8(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, void* out, void* ws, int B, int Hq, int Hkv, int P,
    int D, const void* table, int max_pages, const void* lengths,
    int len_scalar, int window, float sm_scale, int n_split, void* stream) {
  const PagedRows rows{static_cast<const int*>(table), max_pages, P};
  return launch<int8_t>(q, k, v, k_scale, v_scale, out, ws, B, Hq, Hkv, D,
                        rows, lengths, len_scalar, window, sm_scale, n_split,
                        stream);
}
