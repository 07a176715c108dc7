// The split-KV skeleton of the paged-decode kernels, for Hopper (sm_90a):
// paged_decode.cu (pools of q's type) and paged_decode_int8.cu (int8 code
// pools with one fp32 scale per (page, kv head)) each instantiate it with
// their pool type and export their own C entry. The design and its
// reasons are in paged_decode.cu's note.
//
// Two launches on the caller's stream:
//   1. paged_decode_split_kernel, grid (splits, kvh, B), 128 threads:
//      block (s, h, b) takes keys [s * kSplit, (s + 1) * kSplit) of row b,
//      cut at the row's length, for the G query heads of kv head h, and
//      writes their unnormalised softmax state (m, l, acc[hd]) in fp32 to
//      the workspace. A block whose split starts at or past the row's
//      length exits at once and writes nothing.
//   2. paged_decode_merge_kernel, a warp per (row, kv head, head),
//      combines its non-empty splits in split order.
//
// Workspace (fp32, the wrapper's): acc [splits][B][kvh][G][hd], then
// (m, l) [splits][B][kvh][G][2].

#pragma once

#include <type_traits>

#include "flash_common.cuh"

// Internal linkage: each of the two libraries holds its own copy.
namespace paged {
namespace {

using flash::kNegInf;

constexpr int kThreads = 128;   // 4 warps
constexpr int kSplit = 64;      // keys of a split: see paged_decode.cu
constexpr int kMaxG = 8;

// Row stride in shared memory, in elements: one kv head of one key (hd
// elements) padded by 16 bytes, so that the rows 8 lanes read at one
// column fall on 8 different bank quads.
template <typename E, int HD>
__host__ __device__ constexpr int row_ld() {
  return HD + 16 / int(sizeof(E));
}

// K and V of a split, q in fp32, the scores (then weights) of every head,
// and the int8 pools' per-key scales.
template <typename E, int HD>
constexpr size_t smem_bytes() {
  return 2 * size_t(kSplit) * row_ld<E, HD>() * sizeof(E) +
         sizeof(float) * (size_t(kMaxG) * HD + size_t(kMaxG) * kSplit +
                          2 * size_t(kSplit));
}

// Four int8 codes (one 32-bit word) to fp32, exactly for every code: the
// code + 128 becomes the low mantissa byte of 2^23 by one byte permute,
// and one subtraction of 2^23 + 128 leaves the code. (No shift, mask or
// integer conversion per code.)
__device__ __forceinline__ void codes4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;   // each code + 128, unsigned
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

// Pool elements widened to fp32: of16 the kN elements of 16 bytes, of4
// four elements from a pointer aligned to four of them.
template <typename E>
struct Wide;

template <>
struct Wide<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void of16(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ __forceinline__ static void of4(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
};

__device__ __forceinline__ float2 to_f2(__nv_bfloat162 x) {
  return __bfloat1622float2(x);
}
__device__ __forceinline__ float2 to_f2(__half2 x) {
  return __half22float2(x);
}

// bf16 and fp16 (H2: two of them in 32 bits)
template <typename H, typename H2>
struct Wide16 {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void of16(const uint4& r, float* f) {
    const H2* h = reinterpret_cast<const H2*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = to_f2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ __forceinline__ static void of4(const H* p, float* f) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    const float2 a = to_f2(*reinterpret_cast<const H2*>(&r.x));
    const float2 b = to_f2(*reinterpret_cast<const H2*>(&r.y));
    f[0] = a.x;
    f[1] = a.y;
    f[2] = b.x;
    f[3] = b.y;
  }
};

template <>
struct Wide<__nv_bfloat16> : Wide16<__nv_bfloat16, __nv_bfloat162> {};
template <>
struct Wide<__half> : Wide16<__half, __half2> {};

template <>
struct Wide<int8_t> {
  static constexpr int kN = 16;
  __device__ __forceinline__ static void of16(const uint4& r, float* f) {
    codes4(r.x, f);
    codes4(r.y, f + 4);
    codes4(r.z, f + 8);
    codes4(r.w, f + 12);
  }
  __device__ __forceinline__ static void of4(const int8_t* p, float* f) {
    codes4(*reinterpret_cast<const uint32_t*>(p), f);
  }
};

// Wait until at most one committed cp.async group of this thread is in
// flight (the newest).
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The split pass. E is the pool's element type (T, or int8_t with
// kscale/vscale [N, kvh]), T q's type.
template <typename E, typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    paged_decode_split_kernel(const T* __restrict__ q,
                              const E* __restrict__ kp,
                              const E* __restrict__ vp,
                              const float* __restrict__ kscale,
                              const float* __restrict__ vscale,
                              const int* __restrict__ block_table,
                              const int* __restrict__ seq_lens,
                              float* __restrict__ ws_acc,
                              float* __restrict__ ws_ml, int B, int kvh,
                              int G, int bs, int max_blocks, float scale) {
  constexpr bool kInt8 = std::is_same<E, int8_t>::value;
  constexpr int LD = row_ld<E, HD>();
  constexpr int EPC = Wide<E>::kN;   // elements of a 16-byte chunk
  constexpr int CH = HD / EPC;       // chunks of a row
  constexpr int C4 = HD / 4;         // 4-column groups of a row
  static_assert(CH >= 1 && HD % EPC == 0, "a row is whole 16-byte chunks");
  extern __shared__ __align__(16) unsigned char smem_pd[];
  __shared__ int pages[kSplit + 1];   // page ids of the split's keys
  E* Ks = reinterpret_cast<E*>(smem_pd);                     // [kSplit][LD]
  E* Vs = Ks + kSplit * LD;                                  // [kSplit][LD]
  float* Qs = reinterpret_cast<float*>(Vs + kSplit * LD);    // [G][HD]
  float* Ps = Qs + kMaxG * HD;                               // [G][kSplit]
  float* Sk = Ps + kMaxG * kSplit;   // int8: kscale of each key x hd^-1/2
  float* Sv = Sk + kSplit;           // int8: vscale of each key

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kb = split * kSplit;
  // The row's length and the page ids of the split's keys load side by
  // side (the table is read only within its width), so the copies below
  // wait for one round trip to device memory, not two.
  const int len = seq_lens[b];
  const int p0 = kb / bs, np = (kb + kSplit - 1) / bs - p0 + 1;
  for (int t = threadIdx.x; t < np; t += kThreads)
    pages[t] = p0 + t < max_blocks
                   ? __ldg(block_table + int64_t(b) * max_blocks + p0 + t)
                   : 0;
  // keys past the table's reach cannot be read: clamp as the plain
  // version's mask does
  const int n = max(0, min(len, max_blocks * bs));
  if (kb >= n) return;
  const int nk = min(kSplit, n - kb);
  __syncthreads();

  // Every K row of the split, then every V row, in one round of 16-byte
  // cp.async each: neighbouring threads copy neighbouring chunks of a
  // row, and nothing at or past the row's length is read. V lands while
  // the scores are formed.
  auto row_off = [&](int r) -> int64_t {
    const int j = kb + r;
    return ((int64_t(pages[j / bs - p0]) * bs + j % bs) * kvh + h) * HD;
  };
  for (int e = threadIdx.x; e < nk * CH; e += kThreads) {
    const int r = e / CH, c = e % CH;
    flash::cp_async16(Ks + r * LD + c * EPC, kp + row_off(r) + c * EPC, 16);
  }
  flash::cp_async_commit();
  for (int e = threadIdx.x; e < nk * CH; e += kThreads) {
    const int r = e / CH, c = e % CH;
    flash::cp_async16(Vs + r * LD + c * EPC, vp + row_off(r) + c * EPC, 16);
  }
  flash::cp_async_commit();
  if constexpr (kInt8) {
    for (int r = threadIdx.x; r < nk; r += kThreads) {
      const int64_t at = int64_t(pages[(kb + r) / bs - p0]) * kvh + h;
      Sk[r] = kscale[at] * scale;
      Sv[r] = vscale[at];
    }
  }
  const T* qrow = q + (int64_t(b) * kvh + h) * G * HD;
  for (int e = threadIdx.x; e < G * HD; e += kThreads)
    Qs[e] = flash::to_f<T>(qrow[e]);
  cp_async_wait_one();   // K has landed
  __syncthreads();

  // Scores of every (head, key) pair in fp32, multiplied by hd^-1/2 (int8:
  // the dot of the raw codes by kscale x hd^-1/2). Thread t takes key
  // t % 64 for heads t / 64, t / 64 + 2, ...: each 16-byte chunk of the
  // key is widened once for all its heads, and a warp (32 keys, the same
  // heads) reads q's rows by broadcast.
  {
    constexpr int kGroups = kThreads / kSplit;   // head groups: 2
    constexpr int kPer = kMaxG / kGroups;        // heads a thread: <= 4
    const int r = threadIdx.x % kSplit, g0 = threadIdx.x / kSplit;
    if (r < nk) {
      const E* kr = Ks + r * LD;
      float part[kPer][2] = {};
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        float kf[EPC];
        Wide<E>::of16(*reinterpret_cast<const uint4*>(kr + c * EPC), kf);
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int g = g0 + i * kGroups;
          if (g >= G) break;
          const float4* q4 =
              reinterpret_cast<const float4*>(Qs + g * HD + c * EPC);
#pragma unroll
          for (int k = 0; k < EPC / 4; ++k) {
            const float4 qv = q4[k];
            float& a = part[i][k & 1];
            a = fmaf(qv.x, kf[4 * k], a);
            a = fmaf(qv.y, kf[4 * k + 1], a);
            a = fmaf(qv.z, kf[4 * k + 2], a);
            a = fmaf(qv.w, kf[4 * k + 3], a);
          }
        }
      }
      const float sc = kInt8 ? Sk[r] : scale;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int g = g0 + i * kGroups;
        if (g < G) Ps[g * kSplit + r] = (part[i][0] + part[i][1]) * sc;
      }
    }
  }
  __syncthreads();

  // The split's softmax, one warp a head: ONE max over the split's keys,
  // p = exp(s - m), l = sum p. (The online rescale happens once a split,
  // in the merge.) int8: the weight kept for P.V is p x vscale.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t per_split = int64_t(B) * kvh * G;
  const int64_t idx0 = (int64_t(b) * kvh + h) * G;   // (b, h, head 0)
  for (int g = warp; g < G; g += kThreads / 32) {
    float* pg = Ps + g * kSplit;
    float s[kSplit / 32];
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < kSplit / 32; ++i) {
      const int r = lane + 32 * i;
      s[i] = r < nk ? pg[r] : kNegInf;
      mx = fmaxf(mx, s[i]);
    }
    mx = warp_max(mx);
    float l = 0.f;
#pragma unroll
    for (int i = 0; i < kSplit / 32; ++i) {
      const int r = lane + 32 * i;
      const float p = r < nk ? expf(s[i] - mx) : 0.f;
      l += p;
      pg[r] = r < nk ? (kInt8 ? p * Sv[r] : p) : 0.f;
    }
    l = warp_sum(l);
    if (lane == 0)
      *reinterpret_cast<float2*>(ws_ml + 2 * (split * per_split + idx0 + g)) =
          make_float2(mx, l);
  }
  flash::cp_async_wait_all();   // V has landed
  __syncthreads();

  // acc = P.V: a thread takes 4 columns of one head over the split's keys
  // (two interleaved sums, added at the end); a warp reads whole rows.
  for (int e = threadIdx.x; e < G * C4; e += kThreads) {
    const int g = e / C4, c = e % C4;
    const float* pg = Ps + g * kSplit;
    float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
    int r = 0;
#pragma unroll 4
    for (; r + 1 < nk; r += 2) {
      float v0[4], v1[4];
      Wide<E>::of4(Vs + r * LD + 4 * c, v0);
      Wide<E>::of4(Vs + (r + 1) * LD + 4 * c, v1);
      const float p0 = pg[r], p1 = pg[r + 1];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a0[i] = fmaf(p0, v0[i], a0[i]);
        a1[i] = fmaf(p1, v1[i], a1[i]);
      }
    }
    if (r < nk) {
      float v0[4];
      Wide<E>::of4(Vs + r * LD + 4 * c, v0);
      const float p0 = pg[r];
#pragma unroll
      for (int i = 0; i < 4; ++i) a0[i] = fmaf(p0, v0[i], a0[i]);
    }
    float* a = ws_acc + (split * per_split + idx0 + g) * HD;
    reinterpret_cast<float4*>(a)[c] = make_float4(
        a0[0] + a1[0], a0[1] + a1[1], a0[2] + a1[2], a0[3] + a1[3]);
  }
}

// The merge: one warp per (row, kv head, head), over the row's non-empty
// splits, with merge_softmax_partials's math: M = max m, w = exp(m - M),
// L = sum l w, out = sum acc w / max(L, 1e-30). Lane s holds split s's
// (m, l) and lane c columns 4c..4c+3 of every split's acc, 32 splits a
// round; the first round's loads are all issued before M is known, so a
// row of up to 32 splits (2048 keys) waits for one round trip to L2.
// Every lane then adds l w, and lane c its columns times w, split after
// split in split order, taking each split's w and l from the lane that
// loaded them. An empty split's terms (m = -1e30, l = 0, acc = 0) have
// weight exactly 0, so skipping them gives the same bits; a row of
// length 0 has no split and gives 0 / 1e-30 = 0.
template <int HD>
__global__ void __launch_bounds__(256)
    paged_decode_merge_kernel(const float* __restrict__ ws_acc,
                              const float* __restrict__ ws_ml,
                              const int* __restrict__ seq_lens,
                              float* __restrict__ out, int B, int kvh,
                              int G, int max_keys) {
  constexpr int V4 = HD / 4;                      // float4 columns: <= 32
  const int64_t per_split = int64_t(B) * kvh * G;
  const int64_t idx = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (idx >= per_split) return;                   // the whole warp
  const int b = int(idx / (int64_t(kvh) * G));
  const int n = max(0, min(seq_lens[b], max_keys));
  const int ns = (n + kSplit - 1) / kSplit;
  auto ml_of = [&](int s) {
    return s < ns ? *reinterpret_cast<const float2*>(
                        ws_ml + 2 * (s * per_split + idx))
                  : make_float2(kNegInf, 0.f);
  };
  auto cols_of = [&](int s) {
    return lane < V4 && s < ns
               ? reinterpret_cast<const float4*>(
                     ws_acc + (s * per_split + idx) * HD)[lane]
               : make_float4(0.f, 0.f, 0.f, 0.f);
  };

  float4 a[32];
#pragma unroll
  for (int u = 0; u < 32; ++u) a[u] = cols_of(u);
  float2 ml = ml_of(lane);
  float M = ml.x;
  for (int s = lane + 32; s < ns; s += 32)
    M = fmaxf(M, ws_ml[2 * (s * per_split + idx)]);
  M = warp_max(M);
  float L = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < ns; s0 += 32) {
    if (s0 > 0) {
      ml = ml_of(s0 + lane);
#pragma unroll
      for (int u = 0; u < 32; ++u) a[u] = cols_of(s0 + u);
    }
    const float w = s0 + lane < ns ? expf(ml.x - M) : 0.f;
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      if (s0 + u >= ns) break;
      const float wu = __shfl_sync(0xffffffffu, w, u);
      L = fmaf(__shfl_sync(0xffffffffu, ml.y, u), wu, L);
      acc.x = fmaf(a[u].x, wu, acc.x);
      acc.y = fmaf(a[u].y, wu, acc.y);
      acc.z = fmaf(a[u].z, wu, acc.z);
      acc.w = fmaf(a[u].w, wu, acc.w);
    }
  }
  if (lane < V4) {
    const float ls = fmaxf(L, 1e-30f);
    reinterpret_cast<float4*>(out + idx * HD)[lane] =
        make_float4(acc.x / ls, acc.y / ls, acc.z / ls, acc.w / ls);
  }
}

struct Args {
  const void *q, *kp, *vp;
  const float *kscale, *vscale;   // int8 pools only
  const int *table, *lens;
  float *out, *ws_acc, *ws_ml;
  int B, kvh, G, bs, max_blocks;
  float scale;
  cudaStream_t stream;
};

// Splits of a table of max_blocks pages of bs keys.
inline int64_t splits_of(int max_blocks, int bs) {
  return (int64_t(max_blocks) * bs + kSplit - 1) / kSplit;
}

// Checks the shape and carves ws (ws_floats floats) into a.ws_acc and
// a.ws_ml; false for a shape or workspace the kernels do not take.
inline bool prepare(Args& a, int hd, float* ws, long long ws_floats) {
  if (a.B < 0 || a.B > 65535 || a.kvh < 1 || a.kvh > 65535 || a.G < 1 ||
      a.G > kMaxG || a.bs < 1 || a.max_blocks < 1)
    return false;
  const int64_t splits = splits_of(a.max_blocks, a.bs);
  const int64_t rows = int64_t(a.B) * a.kvh * a.G;
  if (splits > 0x7fffffff || ws_floats < splits * rows * (hd + 2))
    return false;
  a.ws_acc = ws;
  a.ws_ml = ws + splits * rows * hd;
  return true;
}

template <typename E, typename T, int HD>
int launch(const Args& a) {
  auto kernel = paged_decode_split_kernel<E, T, HD>;
  constexpr size_t smem = smem_bytes<E, HD>();
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const dim3 grid(unsigned(splits_of(a.max_blocks, a.bs)), unsigned(a.kvh),
                  unsigned(a.B));
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const E*>(a.kp),
      static_cast<const E*>(a.vp), a.kscale, a.vscale, a.table, a.lens,
      a.ws_acc, a.ws_ml, a.B, a.kvh, a.G, a.bs, a.max_blocks, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int64_t n = int64_t(a.B) * a.kvh * a.G * 32;   // a warp each
  paged_decode_merge_kernel<HD><<<unsigned((n + 255) / 256), 256, 0,
                                  a.stream>>>(
      a.ws_acc, a.ws_ml, a.lens, a.out, a.B, a.kvh, a.G,
      a.max_blocks * a.bs);
  return int(cudaGetLastError());
}

// The two launches for a run-time head dim; -1 for one not taken.
template <typename E, typename T>
int launch_typed(const Args& a, int hd) {
  if (a.B == 0) return 0;
  switch (hd) {
    case 16: return launch<E, T, 16>(a);
    case 32: return launch<E, T, 32>(a);
    case 64: return launch<E, T, 64>(a);
    case 128: return launch<E, T, 128>(a);
    default: return -1;
  }
}

}  // namespace
}  // namespace paged
