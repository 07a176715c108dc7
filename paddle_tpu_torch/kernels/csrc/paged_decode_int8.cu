// Ragged paged-attention decode over an int8 KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_kernel_int8` in
// paddle_tpu/kernels/paged_attention.py (launched by
// `_paged_attention_pallas_int8`): one query token per row attends over the
// row's KV history, which lives in a block pool of int8 codes read through a
// block table and dequantized inside the kernel.
//
//   q           [B, kvh, G, hd]   bf16 | fp16 | fp32
//   k/v pages   [N, bs, kvh, hd]  int8 codes; page 0 is the NULL page
//   kscale      [N, kvh]          fp32: key j of page p, head h is
//   vscale      [N, kvh]                code * kscale[p, h] (values alike)
//   block_table [B, max_blocks]   int32 page ids
//   seq_lens    [B]               int32 valid keys per row
//   out         [B, kvh, G, hd]   fp32 = softmax(q.K^T / sqrt(hd)).V over
//                                 the row's first seq_lens[b] keys
//   ws          fp32 workspace of the split partials (the wrapper's)
//
// What bounds it: bytes. A key (or value) of one kv head is hd bytes of
// codes, used by the G query heads of that head and by nothing else: 2G
// flops per byte of codes, far below what the card can do per byte. The
// int8 pool halves the bytes of a bf16 pool, which is what its users keep
// it for. One block per (kv head, row) left most of the 132 SMs idle.
//
// What the design does about it: the skeleton of paged_decode.cu
// (paged_decode.cuh), with the pool's element an int8 code:
// - split-KV over separate blocks of 64 keys each, grid (split, kv head,
//   row), the split count ceil(max_blocks * bs / 64) from the table's
//   width alone, blocks past a row's length exiting at once;
// - a split's codes (64 rows of hd bytes each for K and for V, 18 KB at
//   hd = 128 with the padding) copied to shared memory in one round of
//   16-byte cp.async, with the two scales of each key's page;
// - one max and one sum a head per split; then the merge launch, which
//   combines a row's splits in split order with merge_softmax_partials's
//   math, without atomics.
// Codes widen four at a time: the four bytes of a word, each + 128, become
// the low mantissa byte of 2^23 by one byte permute (prmt), and one
// subtraction of 2^23 + 128 leaves each code, exactly for every code. That
// replaces a shift, a mask and an integer-to-float conversion per code.
// The arithmetic is the reference's `_int8_block_update`: the dot product
// runs on the raw codes and is scaled once per key by kscale * hd^-1/2,
// and p is scaled by vscale before it weights the value codes; both
// scales come from the key's page and kv head.
//
// Keys at or past seq_lens[b] are never read, codes and scales alike, so
// a row of length 0 comes out as exact zeros, and the NULL page (where
// inactive and mid-prefill rows scatter their codes and grow its scale)
// reaches no output, NaN scales included. Like the TPU kernel, masked
// scores are the finite -1e30 and the output divides by max(l, 1e-30).
//
// Taken: hd in {16, 32, 64, 128}, 1 <= G <= 8, any bs (the Python wrapper
// admits 8, 16 and 32; the TPU kernel needed bs % 32 == 0).

#include "paged_decode.cuh"

// dtype of q: 0 = fp32, 1 = fp16, 2 = bf16. ws holds ws_floats floats, at
// least ceil(max_blocks * bs / 64) * B * kvh * G * (hd + 2). Returns -1 for
// a shape, type or workspace the kernels do not take, else
// cudaGetLastError() after the two launches. Launches on `stream` and does
// not synchronise.
extern "C" int paged_decode_int8_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const float* kscale, const float* vscale, const int* block_table,
    const int* seq_lens, float* out, float* ws, long long ws_floats, int B,
    int kvh, int G, int hd, int bs, int max_blocks, int dtype, float scale,
    void* stream) {
  paged::Args a{q,       k_pages, v_pages, kscale,  vscale,
                block_table, seq_lens, out, nullptr, nullptr,
                B,       kvh,     G,       bs,      max_blocks,
                scale,   static_cast<cudaStream_t>(stream)};
  if (!paged::prepare(a, hd, ws, ws_floats)) return -1;
  switch (dtype) {
    case 0: return paged::launch_typed<int8_t, float>(a, hd);
    case 1: return paged::launch_typed<int8_t, __half>(a, hd);
    case 2: return paged::launch_typed<int8_t, __nv_bfloat16>(a, hd);
    default: return -1;
  }
}
