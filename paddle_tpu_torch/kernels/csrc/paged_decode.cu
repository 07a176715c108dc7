// Ragged paged-attention decode for Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_kernel` in
// paddle_tpu/kernels/paged_attention.py (launched by
// `paged_attention_pallas`): one query token per row attends over the
// row's KV history, which lives in a block pool read through a block
// table.
//
//   q           [B, kvh, G, hd]   bf16 | fp16 | fp32
//   k/v pages   [N, bs, kvh, hd]  same type as q; page 0 is the NULL page
//   block_table [B, max_blocks]   int32 page ids
//   seq_lens    [B]               int32 valid keys per row
//   out         [B, kvh, G, hd]   fp32 = softmax(q.K^T / sqrt(hd)).V over
//                                 the row's first seq_lens[b] keys
//   ws          fp32 workspace of the split partials (the wrapper's)
//
// What bounds it: bytes. Each key and value is used by the G query heads
// of its kv head and by nothing else, so a row moves about
// 2 * len * kvh * hd * 2 bytes in bf16 for 4 * len * kvh * G * hd flops:
// G flops per byte, far below the card's ~295 flops per byte of bf16.
// The card reaches its memory rate only with many bytes in flight on
// every SM; one block per (kv head, row) gave 32 blocks for 132 SMs at
// llama3-8b decode shapes, and the card's time was one SM's serial walk
// of the longest row.
//
// What the design does about it (paged_decode.cuh holds the code shared
// with paged_decode_int8.cu):
//
// 1. Split-KV over separate blocks. A row's keys are cut into splits of
//    kSplit = 64 keys, one block of 128 threads per (split, kv head,
//    row); the split count is ceil(max_blocks * bs / 64), from the block
//    table's width alone, so the wrapper reads nothing back from the
//    card. 64 keys start every split on a page for bs 8, 16 and 32. Why
//    64 and not 128: phase 4 of chip_smoke.py (a 40-page table of 16
//    keys, 4 rows, 8 kv heads) gets 320 blocks instead of 160, and a row
//    of 2000 keys 256 instead of 128, each walking half as far; a split's
//    K and V (34 KB in bf16 at hd = 128) still fit five blocks to an SM.
//    The partial a split leaves (hd + 2 floats a query head) is 6% of the
//    bf16 bytes it summarises at G = 4, hd = 128. A block whose split
//    starts at or past its row's length exits at once.
// 2. A split is one tile: every K and V row of it is copied to shared
//    memory in one round of 16-byte cp.async (neighbouring threads on
//    neighbouring chunks of a row, so a warp reads whole sectors), so all
//    of a block's bytes are in flight at once. Then all G x 64 scores are
//    formed, and each head takes ONE max and one sum of exp(s - m) for
//    the split, as the TPU kernel's per-page update does: no per-key
//    rescale of the accumulator and no per-key shuffle reduction. P.V
//    follows with each thread on 4 columns of one head. Scores, weights
//    and sums are fp32; scores are multiplied by hd^-1/2.
// 3. A deterministic merge: a second launch combines each (row, kv head,
//    head)'s non-empty splits in split order with
//    merge_softmax_partials's math (paged_attention.py). No atomics, so
//    two launches give the same bits. Why a second launch and not the
//    last block of each (row, kv head) merging in the first: on an H100
//    that single launch took about 3% less device time (PERF.md), and
//    it needs a zeroed per-(row, kv head) counter that outlives the call
//    and that launches on two streams would share.
//
// Keys at or past seq_lens[b] are never read, so a row of length 0 has
// no split and comes out as exact zeros, and the NULL page (where
// inactive rows scatter their K/V, racing) reaches no output, NaN
// included. Like the TPU kernel, masked scores are the finite -1e30 and
// the output divides by max(l, 1e-30).
//
// Taken: hd in {16, 32, 64, 128}, 1 <= G <= 8, any bs (the Python
// wrapper admits 8, 16 and 32). TMA and tensor cores are not used: at
// G flops per byte the CUDA cores are far from their limit.

#include "paged_decode.cuh"

// dtype: 0 = fp32, 1 = fp16, 2 = bf16. ws holds ws_floats floats, at
// least ceil(max_blocks * bs / 64) * B * kvh * G * (hd + 2). Returns -1
// for a shape, type or workspace the kernels do not take, else
// cudaGetLastError() after the two launches. Launches on `stream` and
// does not synchronise.
extern "C" int paged_decode_attention(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const int* block_table,
                                      const int* seq_lens, float* out,
                                      float* ws, long long ws_floats, int B,
                                      int kvh, int G, int hd, int bs,
                                      int max_blocks, int dtype, float scale,
                                      void* stream) {
  paged::Args a{q,       k_pages, v_pages, nullptr, nullptr,
                block_table, seq_lens, out, nullptr, nullptr,
                B,       kvh,     G,       bs,      max_blocks,
                scale,   static_cast<cudaStream_t>(stream)};
  if (!paged::prepare(a, hd, ws, ws_floats)) return -1;
  switch (dtype) {
    case 0: return paged::launch_typed<float, float>(a, hd);
    case 1: return paged::launch_typed<__half, __half>(a, hd);
    case 2: return paged::launch_typed<__nv_bfloat16, __nv_bfloat16>(a, hd);
    default: return -1;
  }
}
