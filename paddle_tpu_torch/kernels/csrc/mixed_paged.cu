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
//
// The arithmetic is the TPU kernel's: scores in fp32 multiplied by
// hd^-1/2, masked keys at the finite -1e30 with their weight set to 0,
// an fp32 online softmax (m, l, acc), P kept in fp32 for P.V, and
// out = acc / max(l, 1e-30). Padding queries (i >= q_len) are not the
// caller's concern: a query tile that holds only padding writes zeros,
// and a padding query beside real ones gives finite values. A row with
// kv_len 0 gives exact zeros.
//
// What bounds it: operations for prefill chunks, bytes for decode rows.
// A chunk of q_len queries does 4 G hd flops per (query, visible key) on
// one read of the row's keys; a decode row reads every key for G queries.
//
// What the design does about it: the TPU kernel runs one program per
// (row, kv head) over all T * G query rows, with a T*G x hd accumulator
// in VMEM. At T = 128 and G = 4 that is 512 x hd fp32, which no block
// here holds in registers, so the query rows are tiled as well: one
// block per (64-row query tile, kv head, row), query row r = i * G + g.
// The tile stays in shared memory as fp32 and the row's keys stream
// through one shared buffer in 64-key tiles gathered page by page
// through the block table (K for the scores, then V for P.V), as in
// flash_fwd.cu: each thread computes a 4 x 8 tile of scores and a
// 4 x hd/8 tile of the output with fp32 FMAs on the CUDA cores (tensor
// cores, TMA and split-KV are later work). A tile's key walk stops at
// its last real query's causal limit, where the TPU kernel walks every
// page of the row.
//
// The NULL page: padding slots and idle lanes all write page 0 (racing
// duplicate writes on this card), and padded table entries point there.
// No key at or past a tile's walk end, which is at most kv_len, is ever
// read: the buffer is zero-filled there and the weight of every masked
// key is exactly 0, so whatever page 0 holds, NaN included, never
// reaches the output.
//
// Taken: hd in {16, 32, 64, 128}, 1 <= G <= 8, any bs (the Python
// wrapper admits 8, 16 and 32), any T >= 1.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBR = 64;   // query rows (i * G + g) of a block
constexpr int kBK = 64;   // keys of a shared-memory tile

template <int D>
constexpr size_t mixed_smem_bytes() {
  return sizeof(float) * (kBR * (D + 1) + kBK * (D + 1) + kBR * (kBK + 1));
}

// Keys [k0, k0 + kBK) of kv head h, through one row's block table, into
// dst[kBK][D + 1] as fp32. Keys at or past n_end are zeros and are not
// read. Consecutive threads read consecutive elements of a key.
template <typename T, int D>
__device__ __forceinline__ void load_keys(float* dst, const T* pool,
                                          const int* table, int k0,
                                          int n_end, int bs, int kvh,
                                          int h) {
  for (int e = threadIdx.x; e < kBK * D; e += kThreads) {
    const int t = e / D, d = e % D;
    const int j = k0 + t;
    float x = 0.f;
    if (j < n_end) {
      const int64_t page = table[j / bs];
      x = to_f<T>(pool[((page * bs + j % bs) * kvh + h) * D + d]);
    }
    dst[t * (D + 1) + d] = x;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    mixed_paged_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp,
                       const int* __restrict__ block_table,
                       const int* __restrict__ kv_lens,
                       const int* __restrict__ q_lens,
                       float* __restrict__ out, int T_, int kvh, int G,
                       int bs, int max_blocks, float scale) {
  constexpr int LDD = D + 1;
  constexpr int LDP = kBK + 1;
  constexpr int RI = 4;        // query rows per thread
  constexpr int CJ = 8;        // key columns per thread
  constexpr int DJ = D / 8;    // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                  // [kBR][LDD]
  float* KVs = Qs + kBR * LDD;       // [kBK][LDD]: K, then V
  float* Ps = KVs + kBK * LDD;       // [kBR][LDP]

  const int b = blockIdx.z, h = blockIdx.y;
  const int r0 = blockIdx.x * kBR;
  const int rows = T_ * G;           // query rows of (b, h)
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  // keys past the table's reach cannot be read: clamp like the mask does
  const int n = max(0, min(kv_lens[b], max_blocks * bs));
  const int qn = max(0, min(q_lens[b], T_));
  const int* table = block_table + int64_t(b) * max_blocks;
  // element (i, g, d) of (b, h) lies at base + i * step + g * D + d
  const int64_t step = int64_t(kvh) * G * D;
  const int64_t base = (int64_t(b) * T_ * kvh + h) * G * D;

  // the tile's last real query row and the keys it may see: the walk
  // stops there (causal skip); padding rows see no more than that
  const int r_last = min(r0 + kBR, qn * G) - 1;
  const int n_end =
      r_last < r0 ? 0 : max(0, min(n, n - qn + r_last / G + 1));
  if (n_end == 0) {  // padding only, an empty row, or nothing visible
    for (int e = threadIdx.x; e < kBR * D; e += kThreads) {
      const int r = r0 + e / D;
      if (r < rows) out[base + (r / G) * step + (r % G) * D + e % D] = 0.f;
    }
    return;
  }

  for (int e = threadIdx.x; e < kBR * D; e += kThreads) {
    const int rr = e / D, d = e % D;
    const int r = r0 + rr;
    float x = 0.f;
    if (r < rows) x = to_f<T>(q[base + (r / G) * step + (r % G) * D + d]);
    Qs[rr * LDD + d] = x;
  }

  float m[RI], l[RI], acc[RI][DJ];
  int lim[RI];                 // each row's last visible key position
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    lim[i] = n - qn + (r0 + ty + 16 * i) / G;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int n_kt = (n_end + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's P.V is done with KVs and Ps
    load_keys<T, D>(KVs, kp, table, k0, n_end, bs, kvh, h);
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = Qs[(ty + 16 * i) * LDD + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = KVs[(tx + 8 * j) * LDD + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      bool ok[CJ];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kj = k0 + tx + 8 * j;
        ok[j] = kj < n_end && kj <= lim[i];
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
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
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        Ps[r * LDP + tx + 8 * j] = p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // P complete; every read of K done
    load_keys<T, D>(KVs, vp, table, k0, n_end, bs, kvh, h);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = Ps[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = KVs[c * LDD + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j)
          acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= rows) continue;
    const float ls = fmaxf(l[i], 1e-30f);
    float* o = out + base + (r / G) * step + (r % G) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[tx + 8 * j] = acc[i][j] / ls;
  }
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const int* kv_lens, const int* q_lens, float* out, int B, int T_,
           int kvh, int G, int bs, int max_blocks, float scale,
           cudaStream_t stream) {
  const size_t smem = mixed_smem_bytes<D>();
  auto kernel = mixed_paged_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((T_ * G + kBR - 1) / kBR, kvh, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, kv_lens, q_lens, out, T_, kvh, G, bs,
      max_blocks, scale);
  return int(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* q, const void* kp, const void* vp,
                 const int* table, const int* kv_lens, const int* q_lens,
                 float* out, int B, int T_, int kvh, int G, int hd, int bs,
                 int max_blocks, float scale, cudaStream_t stream) {
  FLASH_DISPATCH_D(hd, launch, T, q, kp, vp, table, kv_lens, q_lens, out, B,
                   T_, kvh, G, bs, max_blocks, scale, stream)
}

}  // namespace

// dtype: 0 = fp32, 1 = fp16, 2 = bf16. Returns -1 for a shape or type
// the kernel does not take, else cudaGetLastError() after the launch.
// Launches on `stream` and does not synchronise.
extern "C" int mixed_paged_attention(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const int* block_table,
                                     const int* kv_lens, const int* q_lens,
                                     float* out, int B, int T, int kvh, int G,
                                     int hd, int bs, int max_blocks,
                                     int dtype, float scale, void* stream) {
  if (B < 0 || B > 65535 || T < 1 || kvh < 1 || kvh > 65535 || G < 1 ||
      G > 8 || bs < 1 || max_blocks < 1)
    return -1;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH_T(dtype, launch_typed, q, k_pages, v_pages, block_table,
                   kv_lens, q_lens, out, B, T, kvh, G, hd, bs, max_blocks,
                   scale, s)
}
