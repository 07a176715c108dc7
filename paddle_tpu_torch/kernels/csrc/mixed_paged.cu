// Mixed prefill-chunk + decode paged attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_mixed_kernel` in
// paddle_tpu/kernels/paged_attention.py (launched by
// `mixed_attention_pallas`): one launch serves every row of a serving
// step, whatever it carries. A row holds a window of q_len query tokens,
// LEFT-aligned in T slots: a prefill chunk, a speculative verify window
// or one decode token. The window's own K/V are already in the pool
// (scatter-then-attend), so query i of row b sits at position
// kv_len[b] - q_len[b] + i and attends to every resident position up to
// its own, read through the row's block table.
//
//   q           [B, T, kvh, G, hd]  bf16 | fp16 | fp32
//   k/v pages   [N, bs, kvh, hd]    same type as q; page 0 is the NULL page
//   block_table [B, max_blocks]     int32 page ids
//   kv_lens     [B]                 int32 resident keys, the window's included
//   q_lens      [B]                 int32 valid queries of the window
//   out         [B, T, kvh, G, hd]  fp32 softmax(q.K^T / sqrt(hd)).V
//   ws          fp32 workspace of the split partials (the wrapper's)
//
// The arithmetic is the TPU kernel's: scores in fp32 multiplied by
// hd^-1/2, masked keys at the finite -1e30 with their weight set to 0,
// an fp32 online softmax (m, l, acc), and out = acc / max(l, 1e-30). The
// query rows of (b, h) are r = i * G + g. Padding queries (i >= q_len)
// and rows with kv_len 0 come out as exact zeros.
//
// What bounds it: bytes for decode rows (every resident key of the row
// read for G queries), operations for prefill chunks (4 G hd flops per
// query and visible key on one read of the row's keys). At llama3-8b
// decode shapes B x kvh is 32 (row, kv head) pairs against 132 SMs, and
// a decode lane holds G = 4 real query rows.
//
// What the design does about it (two launches):
//
// 1. Split-KV. A row's keys are cut into splits of kSplit = 256 keys, one
//    block each: grid (splits, query tiles, B * kvh) with 128 threads.
//    The split count is ceil(max_blocks * bs / 256), from the block
//    table's width alone; the wrapper reads no length back from the
//    card. 256 keys is 4 tiles of 64: at the decode shapes (up to 2000
//    keys) a row gives 7-8 splits, so 32 pairs become 224-256 blocks,
//    two resident per SM, and a block's partial (hd + 2 floats per query
//    row) is under 2% of the 128 KB of K/V it reads for a decode lane. A
//    block whose split holds no key visible to its rows, or whose rows
//    are all padding, exits at once. Each block writes its unnormalised
//    partial (m, l, acc) in fp32 to the workspace.
// 2. The merge (mixed_paged_merge_kernel) combines the splits of each
//    query row in split order with merge_softmax_partials's math
//    (paged_attention.py:713): M = max m, w = exp(m - M), L = sum l w,
//    out = sum acc w / max(L, 1e-30). It reads only the splits that hold
//    a key visible to the row, which is the same as adding the empty
//    splits' (m = -1e30, l = 0, acc = 0) terms: their weight is exactly
//    0, and with no split at all out is 0 / 1e-30 = 0. No atomics: two
//    launches give the same bits.
//
// Query tiles sized to the real queries: a block holds 64 query rows,
// one 16-row tile per warp (the mma's M dimension). A warp whose rows
// hold no real query, or whose queries see no key of the split, does no
// product; a decode lane (G = 4) costs one 16-row tile. The block's key
// walk stops at its last real query's causal limit, and each warp's at
// its own.
//
// Keys and values are gathered page row by page row through the block
// table: one kv head's key row is hd contiguous elements at
// ((page * bs + slot) * kvh + h) * hd, copied by 16-byte cp.async into a
// 2-stage ring of 64-key tiles (the next tile is in flight while this
// one is used), rows padded by 16 bytes against bank conflicts.
//
// mixed_paged_mma_kernel (bf16, fp16): S = Q.K^T and O += P.V on
// mma.sync.m16n8k16 with fp32 accumulation (flash_common.cuh), Q held
// in registers for the whole walk, as in flash_fwd.cu. The operands are
// in the input type, which the reference widens to fp32 exactly, so S
// differs from it only in summation order. The exponentials are the
// SFU's ex2 with hd^-1/2 log2 e folded into one FFMA (m is the running
// max of the unscaled dot): a few ulps from exp.
// Departure: the TPU kernel keeps P in fp32 for P.V, and rounding P once
// to bf16 would put about 2^-9 relative error into every layer. So P
// enters P.V as two operands of the input type, P_hi = round(P) and
// P_lo = round(P - P_hi), in two products into one accumulator: each
// rounding is within half a unit of 8 significant bits in bf16, so the
// pair is within 2^-16 of P (about 2^-17 on average; fp16 2^-22). In
// fp16, P is first scaled by 2^14 (exactly; the accumulator is scaled
// back at the end) so that P_lo of a small weight stays out of fp16's
// subnormal range.
//
// mixed_paged_kernel (fp32): the same tiles, splits and merge with the
// products as fp32 FMAs on the CUDA cores (the tensor cores have no
// full-fp32 product) and the reference's expf. Lane l of a warp owns
// query rows l / 8 + 4 i (i < 4) of the warp's 16, key columns
// l % 8 + 8 j of a tile and output columns l % 8 + 8 j; P passes through
// the warp's own rows of shared memory.
//
// The NULL page: padding slots and idle lanes all write page 0 (racing
// duplicate writes on this card), and padded table entries point there.
// No key at or past a block's walk end, which is at most kv_len, is ever
// read: the ring is zero-filled there and the weight of every masked key
// is exactly 0, so whatever page 0 holds, NaN included, never reaches
// the output.
//
// Taken: hd in {16, 32, 64, 128}, 1 <= G <= 8, any bs (the Python
// wrapper admits 8, 16 and 32), any T >= 1.

#include <type_traits>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBR = 64;      // query rows (i * G + g) of a block
constexpr int kBK = 64;      // keys of a shared-memory tile
constexpr int kSplit = 256;  // keys of a split; a multiple of kBK

// Row stride in elements: rows padded by 16 bytes.
template <typename T, int D>
__host__ __device__ constexpr int row_ld() {
  return D + 16 / int(sizeof(T));
}

// What one block of (split, query tile) of (row b, kv head h) sees.
struct Block {
  int b, h, r0, rows;   // rows = T * G query rows of (b, h)
  int n, qn, G;         // keys (clamped to the table), valid queries
  int kb, ke;           // its keys [kb, ke): the split, cut at the walk end
};

// The block's keys; false when it has nothing to do (its rows are all
// padding, or none of them sees a key of its split).
__device__ __forceinline__ bool block_keys(Block& k, const int* kv_lens,
                                           const int* q_lens, int T_,
                                           int kvh, int G, int bs,
                                           int max_blocks) {
  k.b = blockIdx.z / kvh;
  k.h = blockIdx.z % kvh;
  k.r0 = blockIdx.y * kBR;
  k.rows = T_ * G;
  k.G = G;
  // keys past the table's reach cannot be read: clamp like the mask does
  k.n = max(0, min(kv_lens[k.b], max_blocks * bs));
  k.qn = max(0, min(q_lens[k.b], T_));
  const int real = min(k.r0 + kBR, k.qn * G);   // rows [r0, real) are real
  if (real <= k.r0) return false;
  const int n_end = min(k.n, k.n - k.qn + (real - 1) / G + 1);
  k.kb = blockIdx.x * kSplit;
  k.ke = min(k.kb + kSplit, n_end);
  return k.kb < k.ke;
}

// The last key position query row r may see (rows past the window see
// every resident key).
__device__ __forceinline__ int row_limit(const Block& k, int r) {
  return min(k.n - 1, k.n - k.qn + r / k.G);
}

// The keys [kb, w_end) the warp's 16 rows from wr0 need; w_end <= kb
// when they hold no real query or see nothing of the split.
__device__ __forceinline__ int warp_end(const Block& k, int wr0) {
  const int real = min(wr0 + 16, k.qn * k.G);
  if (real <= wr0) return k.kb;
  return min(k.ke, row_limit(k, real - 1) + 1);
}

// R rows of D elements of T into dst[R][LD] by 16-byte cp.async; row r
// comes from base + off(r), or is zeros when off(r) < 0. The caller
// commits the group.
template <typename T, int R, int D, int LD, typename Off>
__device__ __forceinline__ void cp_rows(T* dst, const T* base, Off off) {
  constexpr int EPC = 16 / int(sizeof(T));   // elements per chunk
  constexpr int CH = D / EPC;                // chunks per row
  for (int e = threadIdx.x; e < R * CH; e += kThreads) {
    const int r = e / CH, c = e % CH;
    const int64_t o = off(r);
    cp_async16(dst + r * LD + c * EPC, o >= 0 ? base + o + c * EPC : base,
               o >= 0 ? 16 : 0);
  }
}

// The block's query tile: real rows from q, the rest zeros.
template <typename T, int D, int LD>
__device__ __forceinline__ void cp_queries(T* dst, const T* q,
                                           const Block& k, int kvh) {
  // element (i, g, d) of (b, h) lies at base + i * step + g * D + d
  const int64_t step = int64_t(kvh) * k.G * D;
  const int64_t base = (int64_t(k.b) * k.rows * kvh + k.h * k.G) * D;
  const int real = k.qn * k.G;
  cp_rows<T, kBR, D, LD>(dst, q, [&](int rr) -> int64_t {
    const int r = k.r0 + rr;
    return r < real ? base + (r / k.G) * step + (r % k.G) * D : -1;
  });
}

// Keys [k0, k0 + kBK) of kv head h through row b's block table; those at
// or past the block's end are zeros and are not read.
template <typename T, int D, int LD>
__device__ __forceinline__ void cp_keys(T* dst, const T* pool,
                                        const int* table, const Block& k,
                                        int k0, int bs, int kvh) {
  cp_rows<T, kBK, D, LD>(dst, pool, [&](int t) -> int64_t {
    const int j = k0 + t;
    if (j >= k.ke) return -1;
    return ((int64_t(__ldg(table + j / bs)) * bs + j % bs) * kvh + k.h) * D;
  });
}

// Partial of query row r of the block's (b, h) in split blockIdx.x: acc
// at ws_acc + idx * D, (m, l) at ws_ml + 2 idx.
__device__ __forceinline__ int64_t partial_index(const Block& k, int B,
                                                 int kvh, int r) {
  return ((int64_t(blockIdx.x) * B + k.b) * kvh + k.h) * k.rows + r;
}

template <int D>
constexpr size_t mma_smem_bytes() {   // Q, 2 x (K, V); 16-bit elements
  return 2 * size_t(kBR + 4 * kBK) * row_ld<__half, D>();
}

template <int D>
constexpr size_t fp32_smem_bytes() {  // Q, 2 x (K, V), P
  return sizeof(float) *
         (size_t(kBR + 4 * kBK) * row_ld<float, D>() + kBR * (kBK + 8));
}

// P is scaled by this before its split into two operands of T: 1 for
// bf16 (fp32's exponent range); 2^14 for fp16, so that P_lo of a weight
// near 2^-14 is not subnormal. P <= 1, so P 2^14 stays below 65504.
template <typename T>
__device__ __forceinline__ float p_scale();
template <>
__device__ __forceinline__ float p_scale<__nv_bfloat16>() { return 1.f; }
template <>
__device__ __forceinline__ float p_scale<__half>() { return 16384.f; }

// The A fragments of P_hi = round(P) and P_lo = round(P - P_hi) for the
// 16 x 16 block of P held by the accumulators of two n-tiles.
template <typename T>
__device__ __forceinline__ void p_hi_lo(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                        const float (&p0)[4],
                                        const float (&p1)[4]) {
  float a[4], b[4], ra[4], rb[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    a[e] = p0[e] * p_scale<T>();
    b[e] = p1[e] * p_scale<T>();
    ra[e] = a[e] - round_to<T>(a[e]);
    rb[e] = b[e] - round_to<T>(b[e]);
  }
  acc_to_a<T>(hi, a, b);
  acc_to_a<T>(lo, ra, rb);
}

// ------------------------------------------- bf16 / fp16, tensor cores ---

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    mixed_paged_mma_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                           const T* __restrict__ vp,
                           const int* __restrict__ block_table,
                           const int* __restrict__ kv_lens,
                           const int* __restrict__ q_lens,
                           float* __restrict__ ws_acc,
                           float* __restrict__ ws_ml, int B, int T_, int kvh,
                           int G, int bs, int max_blocks, float scale) {
  constexpr int LD = row_ld<T, D>();
  constexpr int KD = D / 16;     // k-steps of Q.K^T
  constexpr int NK = kBK / 8;    // n-tiles of the scores
  constexpr int ND = D / 8;      // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_mx[];
  T* Qs = reinterpret_cast<T*>(smem_mx);     // [kBR][LD]
  T* Ks = Qs + kBR * LD;                     // [2][kBK][LD]
  T* Vs = Ks + 2 * kBK * LD;                 // [2][kBK][LD]

  Block k;
  if (!block_keys(k, kv_lens, q_lens, T_, kvh, G, bs, max_blocks)) return;
  const int* table = block_table + int64_t(k.b) * max_blocks;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wr0 = k.r0 + 16 * warp;
  const int w_end = warp_end(k, wr0);
  const bool active = w_end > k.kb;
  const int lim_first = row_limit(k, wr0);   // the warp's smallest limit
  const int lim[2] = {row_limit(k, wr0 + g), row_limit(k, wr0 + g + 8)};

  cp_queries<T, D, LD>(Qs, q, k, kvh);
  cp_keys<T, D, LD>(Ks, kp, table, k, k.kb, bs, kvh);
  cp_keys<T, D, LD>(Vs, vp, table, k, k.kb, bs, kvh);
  cp_async_commit();

  uint32_t qf[KD][4];
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this lane's part
  const float c = scale * kLog2e;

  for (int k0 = k.kb, kt = 0; k0 < k.ke; k0 += kBK, ++kt) {
    cp_async_wait_all();
    __syncthreads();   // tile kt landed; every warp is done with kt - 1
    if (k0 + kBK < k.ke) {
      const int nxt = (kt + 1) & 1;
      cp_keys<T, D, LD>(Ks + nxt * kBK * LD, kp, table, k, k0 + kBK, bs,
                        kvh);
      cp_keys<T, D, LD>(Vs + nxt * kBK * LD, vp, table, k, k0 + kBK, bs,
                        kvh);
    }
    cp_async_commit();
    if (!active || k0 >= w_end) continue;
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm_x4(qf[kk], frag_a<LD>(Qs, 16 * warp, 16 * kk, lane));
    }
    const T* Kt = Ks + (kt & 1) * kBK * LD;
    const T* Vt = Vs + (kt & 1) * kBK * LD;

    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int n = 0; n < NK; n += 2) {
        uint32_t kb[4];
        ldsm_x4(kb, frag_bt<LD>(Kt, 8 * n, 16 * kk, lane));
        mma16816<T>(s[n], qf[kk], kb[0], kb[1]);
        mma16816<T>(s[n + 1], qf[kk], kb[2], kb[3]);
      }

    // mask (only where a key of the tile can pass a row's limit), and
    // the online softmax of rows wr0 + g (e < 2) and wr0 + g + 8 (e >= 2)
    const bool edge = k0 + kBK - 1 > lim_first;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (edge && k0 + 8 * n + 2 * t + (e & 1) > lim[e >> 1])
          s[n][e] = kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2], mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = exp2_approx((m[r] - m_new) * c);
      m[r] = m_new;
      mc[r] = m_new * c;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_approx(fmaf(s[n][e], c, -mc[e >> 1]));
        if (edge && k0 + 8 * n + 2 * t + (e & 1) > lim[e >> 1]) p = 0.f;
        rs[e >> 1] += p;
        s[n][e] = p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];

    // O += P_hi . V + P_lo . V
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      p_hi_lo<T>(ph, pl, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t vb[4];
        ldsm_x4_t(vb, frag_b<LD>(Vt, 16 * kk, 8 * n, lane));
        mma16816<T>(o[n], ph, vb[0], vb[1]);
        mma16816<T>(o[n + 1], ph, vb[2], vb[3]);
        mma16816<T>(o[n], pl, vb[0], vb[1]);
        mma16816<T>(o[n + 1], pl, vb[2], vb[3]);
      }
    }
  }
  if (!active) return;

  // the partials of the real rows that see a key of the split
  const float unscale = 1.f / p_scale<T>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wr0 + g + 8 * r;
    const float ls = quad_sum(l[r]);
    if (row >= k.qn * G || lim[r] < k.kb) continue;
    const int64_t idx = partial_index(k, B, kvh, row);
    float* a = ws_acc + idx * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(a + 8 * n) =
          make_float2(o[n][2 * r] * unscale, o[n][2 * r + 1] * unscale);
    if (t == 0)
      *reinterpret_cast<float2*>(ws_ml + 2 * idx) =
          make_float2(m[r] * scale, ls);
  }
}

// ------------------------------------------------- fp32, CUDA cores ---

template <int D>
__global__ void __launch_bounds__(kThreads)
    mixed_paged_kernel(const float* __restrict__ q,
                       const float* __restrict__ kp,
                       const float* __restrict__ vp,
                       const int* __restrict__ block_table,
                       const int* __restrict__ kv_lens,
                       const int* __restrict__ q_lens,
                       float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                       int B, int T_, int kvh, int G, int bs, int max_blocks,
                       float scale) {
  constexpr int LD = row_ld<float, D>();
  constexpr int LDP = kBK + 8;   // P rows: the 4 row groups on other banks
  constexpr int RI = 4;          // query rows per lane
  constexpr int CJ = kBK / 8;    // key columns per lane
  constexpr int DJ = D / 8;      // output columns per lane
  extern __shared__ __align__(16) unsigned char smem_mx[];
  float* Qs = reinterpret_cast<float*>(smem_mx);   // [kBR][LD]
  float* Ks = Qs + kBR * LD;                       // [2][kBK][LD]
  float* Vs = Ks + 2 * kBK * LD;                   // [2][kBK][LD]
  float* Ps = Vs + 2 * kBK * LD;                   // [kBR][LDP]

  Block k;
  if (!block_keys(k, kv_lens, q_lens, T_, kvh, G, bs, max_blocks)) return;
  const int* table = block_table + int64_t(k.b) * max_blocks;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tx = lane % 8, ty = lane / 8;
  const int wr0 = k.r0 + 16 * warp;
  const int w_end = warp_end(k, wr0);
  const bool active = w_end > k.kb;
  const int lim_first = row_limit(k, wr0);
  const float* Qw = Qs + 16 * warp * LD;
  float* Pw = Ps + 16 * warp * LDP;

  cp_queries<float, D, LD>(Qs, q, k, kvh);
  cp_keys<float, D, LD>(Ks, kp, table, k, k.kb, bs, kvh);
  cp_keys<float, D, LD>(Vs, vp, table, k, k.kb, bs, kvh);
  cp_async_commit();

  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = k.kb, kt = 0; k0 < k.ke; k0 += kBK, ++kt) {
    cp_async_wait_all();
    __syncthreads();   // tile kt landed; every warp is done with kt - 1
    if (k0 + kBK < k.ke) {
      const int nxt = (kt + 1) & 1;
      cp_keys<float, D, LD>(Ks + nxt * kBK * LD, kp, table, k, k0 + kBK, bs,
                            kvh);
      cp_keys<float, D, LD>(Vs + nxt * kBK * LD, vp, table, k, k0 + kBK, bs,
                            kvh);
    }
    cp_async_commit();
    if (!active || k0 >= w_end) continue;
    const float* Kt = Ks + (kt & 1) * kBK * LD;
    const float* Vt = Vs + (kt & 1) * kBK * LD;

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = Qw[(ty + 4 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = Kt[(tx + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    const bool edge = k0 + kBK - 1 > lim_first;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int lim = row_limit(k, wr0 + ty + 4 * i);
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        s[i][j] = edge && k0 + tx + 8 * j > lim ? kNegInf : s[i][j] * scale;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = edge && k0 + tx + 8 * j > lim ? 0.f
                                                      : expf(s[i][j] - m_new);
        rs += p;
        Pw[(ty + 4 * i) * LDP + tx + 8 * j] = p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();      // the warp's P rows are complete

#pragma unroll 4
    for (int cc = 0; cc < kBK; ++cc) {
      float pv[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = Pw[(ty + 4 * i) * LDP + cc];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vt[cc * LD + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
    __syncwarp();      // every lane is done with P before the next tile
  }
  if (!active) return;

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = wr0 + ty + 4 * i;
    if (row >= k.qn * G || row_limit(k, row) < k.kb) continue;
    const int64_t idx = partial_index(k, B, kvh, row);
#pragma unroll
    for (int j = 0; j < DJ; ++j) ws_acc[idx * D + tx + 8 * j] = acc[i][j];
    if (tx == 0)
      *reinterpret_cast<float2*>(ws_ml + 2 * idx) = make_float2(m[i], l[i]);
  }
}

// ------------------------------------------------------------- merge ---

// One thread per 4 output elements of a query row (b, i, h, g): the row's
// splits that hold a visible key, merged in split order; padding
// queries and rows that see no key are zeros.
template <int D>
__global__ void __launch_bounds__(256)
    mixed_paged_merge_kernel(const float* __restrict__ ws_acc,
                             const float* __restrict__ ws_ml,
                             const int* __restrict__ kv_lens,
                             const int* __restrict__ q_lens,
                             float* __restrict__ out, int B, int T_, int kvh,
                             int G, int max_keys) {
  constexpr int V4 = D / 4;
  const int rows = T_ * G;
  const int64_t per_split = int64_t(B) * kvh * rows;
  const int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= per_split * V4) return;
  const int c4 = int(e % V4);
  const int64_t idx = e / V4;                    // ((b * kvh + h) * rows + r)
  const int r = int(idx % rows);
  const int h = int(idx / rows % kvh), b = int(idx / rows / kvh);
  const int i = r / G, g = r % G;
  const int n = max(0, min(kv_lens[b], max_keys));
  const int qn = max(0, min(q_lens[b], T_));
  const int lim = min(n - 1, n - qn + i);
  const int ns = i < qn && lim >= 0 ? lim / kSplit + 1 : 0;

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (ns > 0) {
    float M = kNegInf;
    for (int s = 0; s < ns; ++s) M = fmaxf(M, ws_ml[2 * (s * per_split + idx)]);
    float L = 0.f;
    for (int s = 0; s < ns; ++s) {
      const int64_t at = s * per_split + idx;
      const float w = expf(ws_ml[2 * at] - M);
      L = fmaf(ws_ml[2 * at + 1], w, L);
      const float4 a = reinterpret_cast<const float4*>(ws_acc + at * D)[c4];
      acc.x = fmaf(a.x, w, acc.x);
      acc.y = fmaf(a.y, w, acc.y);
      acc.z = fmaf(a.z, w, acc.z);
      acc.w = fmaf(a.w, w, acc.w);
    }
    const float ls = fmaxf(L, 1e-30f);
    acc.x /= ls;
    acc.y /= ls;
    acc.z /= ls;
    acc.w /= ls;
  }
  const int64_t o = (((int64_t(b) * T_ + i) * kvh + h) * G + g) * D;
  reinterpret_cast<float4*>(out + o)[c4] = acc;
}

// ------------------------------------------------------------ launch ---

struct Args {
  const void *q, *kp, *vp;
  const int *table, *kv_lens, *q_lens;
  float *out, *ws_acc, *ws_ml;
  int B, T, kvh, G, bs, max_blocks;
  float scale;
  cudaStream_t stream;
};

template <int D>
int merge(const Args& a) {
  const int64_t n = int64_t(a.B) * a.kvh * a.T * a.G * (D / 4);
  const int64_t blocks = (n + 255) / 256;
  if (!grid_fits(blocks, 1)) return -1;
  mixed_paged_merge_kernel<D><<<unsigned(blocks), 256, 0, a.stream>>>(
      a.ws_acc, a.ws_ml, a.kv_lens, a.q_lens, a.out, a.B, a.T, a.kvh, a.G,
      a.max_blocks * a.bs);
  return int(cudaGetLastError());
}

// The split launch's grid: (splits, query tiles, B * kvh); false when it
// is beyond the card's limits.
inline bool split_grid(const Args& a, dim3& grid) {
  const int64_t splits = (int64_t(a.max_blocks) * a.bs + kSplit - 1) / kSplit;
  const int64_t tiles = (int64_t(a.T) * a.G + kBR - 1) / kBR;
  const int64_t pairs = int64_t(a.B) * a.kvh;
  if (!grid_fits(splits, tiles) || pairs > 65535) return false;
  grid = dim3(unsigned(splits), unsigned(tiles), unsigned(pairs));
  return true;
}

template <typename T, int D>
int launch(const Args& a) {
  dim3 grid;
  if (!split_grid(a, grid)) return -1;
  cudaError_t err;
  if constexpr (std::is_same<T, float>::value) {
    auto kernel = mixed_paged_kernel<D>;
    const size_t smem = fp32_smem_bytes<D>();
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    kernel<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.kp),
        static_cast<const float*>(a.vp), a.table, a.kv_lens, a.q_lens,
        a.ws_acc, a.ws_ml, a.B, a.T, a.kvh, a.G, a.bs, a.max_blocks,
        a.scale);
  } else {
    auto kernel = mixed_paged_mma_kernel<T, D>;
    const size_t smem = mma_smem_bytes<D>();
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    kernel<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.kp),
        static_cast<const T*>(a.vp), a.table, a.kv_lens, a.q_lens, a.ws_acc,
        a.ws_ml, a.B, a.T, a.kvh, a.G, a.bs, a.max_blocks, a.scale);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  return merge<D>(a);
}

template <typename T>
int launch_typed(const Args& a, int hd) {
  FLASH_DISPATCH_D(hd, launch, T, a)
}

}  // namespace

// dtype: 0 = fp32, 1 = fp16, 2 = bf16. ws holds ws_floats floats, at
// least ceil(max_blocks * bs / 256) * B * kvh * T * G * (hd + 2): each
// split's acc, then each split's (m, l). Returns -1 for a shape, type or
// workspace the kernels do not take, else cudaGetLastError() after the
// two launches. Launches on `stream` and does not synchronise.
extern "C" int mixed_paged_attention(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const int* block_table,
                                     const int* kv_lens, const int* q_lens,
                                     float* out, float* ws,
                                     long long ws_floats, int B, int T,
                                     int kvh, int G, int hd, int bs,
                                     int max_blocks, int dtype, float scale,
                                     void* stream) {
  if (B < 0 || B > 65535 || T < 1 || kvh < 1 || kvh > 65535 || G < 1 ||
      G > 8 || bs < 1 || max_blocks < 1)
    return -1;
  if (B == 0) return 0;
  const long long splits =
      (static_cast<long long>(max_blocks) * bs + kSplit - 1) / kSplit;
  const long long rows = static_cast<long long>(B) * kvh * T * G;
  if (ws_floats < splits * rows * (hd + 2)) return -1;
  Args a{q,  k_pages, v_pages, block_table, kv_lens,    q_lens,
         out, ws,     ws + splits * rows * hd,  B, T, kvh, G, bs, max_blocks,
         scale, static_cast<cudaStream_t>(stream)};
  FLASH_DISPATCH_T(dtype, launch_typed, a, hd)
}
