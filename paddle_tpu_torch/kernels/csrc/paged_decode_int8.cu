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
//
// What bounds it: bytes. A key (or value) of one kv head is hd bytes of
// codes, used by the G query heads of that head and by nothing else: G/2
// flops per byte of codes, far below what the card can do per byte. The
// int8 pool halves the bytes of a bf16 pool, which is what its users keep it
// for.
//
// What the design does about it, the same layout as paged_decode.cu: every
// code of a row is read from device memory exactly once, coalesced. A thread
// loads 8 bytes (8 codes); the hd codes of one key are read by hd/8
// neighbouring threads, so a warp reads whole 32-byte sectors. (16-byte loads
// would give each thread 16 dimensions, and its q and accumulator for G = 8
// heads would no longer fit in registers.) Each thread issues the loads of
// kUnroll keys, with their pages' two scales, before it uses any of them.
// Codes are widened to fp32 in registers; the dot product runs on the raw
// codes and is scaled once per key by kscale * 1/sqrt(hd), and p is scaled
// once by vscale before it weights the value codes. Scores, the online
// softmax (m, l) and the accumulator stay in fp32 registers.
//
// Layout of the work: one thread block per (kv head, row), holding the G
// query heads of that kv head. Consecutive key slots go to consecutive thread
// groups, so the 8 warps split the keys of each page; each group keeps its
// own online softmax, the groups merge within the warp by shuffles and the
// warps through shared memory.
//
// Keys at or past seq_lens[b] are never read, codes and scales alike, so a
// row of length 0 writes zeros, and the NULL page (where inactive and
// mid-prefill rows scatter their codes and grow its scale) is read only by a
// row whose length reaches into it. Like the TPU kernel, the empty softmax
// starts from the finite -1e30 and the output divides by max(l, 1e-30).
//
// Taken: hd in {16, 32, 64, 128}, 1 <= G <= 8, any bs (the Python wrapper
// admits 8, 16 and 32; the TPU kernel needed bs % 32 == 0).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 8;
constexpr int kUnroll = 8;
constexpr int kVec = 8;  // int8 codes per 8-byte load
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 8 int8 codes, widened to fp32.
__device__ __forceinline__ void widen(const uint2& r, float* f) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = (float)(int8_t)((r.x >> (8 * i)) & 0xff);
    f[4 + i] = (float)(int8_t)((r.y >> (8 * i)) & 0xff);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_decode_int8_kernel(const T* __restrict__ q,
                         const int8_t* __restrict__ kp,
                         const int8_t* __restrict__ vp,
                         const float* __restrict__ kscale,
                         const float* __restrict__ vscale,
                         const int* __restrict__ block_table,
                         const int* __restrict__ seq_lens,
                         float* __restrict__ out, int kvh, int G, int bs,
                         int max_blocks, float scale) {
  constexpr int kTpt = HD / kVec;        // threads per key: 2..16
  constexpr int kTpw = 32 / kTpt;        // keys per warp per step
  constexpr int kSlots = kWarps * kTpw;  // keys per block per step
  static_assert(kTpt >= 1 && kTpt <= 32 && 32 % kTpt == 0,
                "head dim does not tile a warp");

  __shared__ float sm_m[kWarps][kMaxG];
  __shared__ float sm_l[kWarps][kMaxG];
  __shared__ float sm_acc[kWarps][kMaxG][HD];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane % kTpt;           // which 8 codes of the key
  const int slot = warp * kTpw + lane / kTpt;
  const int d0 = sub * kVec;

  // keys past the table's reach cannot be read: clamp like the plain
  // version's page walk does
  const int n = max(0, min(seq_lens[b], max_blocks * bs));
  const int* table = block_table + (size_t)b * max_blocks;
  const size_t tok_stride = (size_t)kvh * HD;
  const size_t page_stride = (size_t)bs * tok_stride;
  const size_t head_off = (size_t)h * HD + d0;

  float qf[kMaxG][kVec];
  const T* qrow = q + ((size_t)b * kvh + h) * G * HD;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      qf[g][i] = g < G ? to_float(qrow[g * HD + d0 + i]) : 0.f;
  }

  float m[kMaxG], l[kMaxG], acc[kMaxG][kVec];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[g][i] = 0.f;
  }

  // The loop bound depends only on the row, so every lane of a warp runs
  // the same iterations and the shuffles below see the full warp.
  for (int base = 0; base < n; base += kSlots * kUnroll) {
    uint2 kr[kUnroll], vr[kUnroll];
    float ks[kUnroll], vs[kUnroll];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pos = base + u * kSlots + slot;
      valid[u] = pos < n;
      if (valid[u]) {
        const int j = pos / bs;
        const int page = table[j];
        const size_t off = (size_t)page * page_stride +
                           (size_t)(pos - j * bs) * tok_stride + head_off;
        kr[u] = *reinterpret_cast<const uint2*>(kp + off);
        vr[u] = *reinterpret_cast<const uint2*>(vp + off);
        ks[u] = kscale[(size_t)page * kvh + h];
        vs[u] = vscale[(size_t)page * kvh + h];
      } else {
        kr[u] = make_uint2(0, 0);
        vr[u] = make_uint2(0, 0);
        ks[u] = 0.f;
        vs[u] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[kVec], vf[kVec];
      widen(kr[u], kf);
      widen(vr[u], vf);
      const float s_scale = ks[u] * scale;
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {  // G is the same for the whole block
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < kVec; ++i) s = fmaf(qf[g][i], kf[i], s);
          // sum over the kTpt threads of this key (aligned groups)
#pragma unroll
          for (int o = kTpt / 2; o > 0; o >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, o);
          if (valid[u]) {
            s *= s_scale;
            const float m_new = fmaxf(m[g], s);
            const float alpha = expf(m[g] - m_new);
            const float p = expf(s - m_new);
            const float pv = p * vs[u];
            l[g] = l[g] * alpha + p;
#pragma unroll
            for (int i = 0; i < kVec; ++i)
              acc[g][i] = fmaf(acc[g][i], alpha, pv * vf[i]);
            m[g] = m_new;
          }
        }
      }
    }
  }

  // merge the kTpw key groups of the warp
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      float mg = m[g];
#pragma unroll
      for (int o = kTpt; o < 32; o <<= 1)
        mg = fmaxf(mg, __shfl_xor_sync(0xffffffffu, mg, o));
      const float c = expf(m[g] - mg);   // 1 when both are -1e30
      float lg = l[g] * c;
#pragma unroll
      for (int o = kTpt; o < 32; o <<= 1)
        lg += __shfl_xor_sync(0xffffffffu, lg, o);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        float a = acc[g][i] * c;
#pragma unroll
        for (int o = kTpt; o < 32; o <<= 1)
          a += __shfl_xor_sync(0xffffffffu, a, o);
        acc[g][i] = a;
      }
      m[g] = mg;
      l[g] = lg;
    }
  }
  if (lane < kTpt) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) sm_acc[warp][g][d0 + i] = acc[g][i];
        if (sub == 0) {
          sm_m[warp][g] = m[g];
          sm_l[warp][g] = l[g];
        }
      }
    }
  }
  __syncthreads();

  // merge the warps: one output element per thread
  float* orow = out + ((size_t)b * kvh + h) * G * HD;
  for (int e = threadIdx.x; e < G * HD; e += kThreads) {
    const int g = e / HD;
    const int d = e % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      lsum += sm_l[w][g] * c;
      a += sm_acc[w][g][d] * c;
    }
    orow[e] = a / fmaxf(lsum, 1e-30f);
  }
}

template <typename T>
int launch_typed(const void* q, const void* kp, const void* vp,
                 const float* kscale, const float* vscale, const int* table,
                 const int* lens, float* out, int B, int kvh, int G, int hd,
                 int bs, int max_blocks, float scale, cudaStream_t stream) {
  const dim3 grid(kvh, B);
  const T* qt = static_cast<const T*>(q);
  const int8_t* kt = static_cast<const int8_t*>(kp);
  const int8_t* vt = static_cast<const int8_t*>(vp);
  switch (hd) {
    case 16:
      paged_decode_int8_kernel<T, 16><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, kscale, vscale, table, lens, out, kvh, G, bs,
          max_blocks, scale);
      break;
    case 32:
      paged_decode_int8_kernel<T, 32><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, kscale, vscale, table, lens, out, kvh, G, bs,
          max_blocks, scale);
      break;
    case 64:
      paged_decode_int8_kernel<T, 64><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, kscale, vscale, table, lens, out, kvh, G, bs,
          max_blocks, scale);
      break;
    case 128:
      paged_decode_int8_kernel<T, 128><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, kscale, vscale, table, lens, out, kvh, G, bs,
          max_blocks, scale);
      break;
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of q: 0 = fp32, 1 = fp16, 2 = bf16. Returns -1 for a shape or type
// the kernel does not take, else cudaGetLastError() after the launch.
// Launches on `stream` and does not synchronise.
extern "C" int paged_decode_int8_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const float* kscale, const float* vscale, const int* block_table,
    const int* seq_lens, float* out, int B, int kvh, int G, int hd, int bs,
    int max_blocks, int dtype, float scale, void* stream) {
  if (G < 1 || G > kMaxG || bs < 1 || max_blocks < 1 || kvh < 1 || B < 0)
    return -1;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_typed<float>(q, k_pages, v_pages, kscale, vscale,
                                 block_table, seq_lens, out, B, kvh, G, hd,
                                 bs, max_blocks, scale, s);
    case 1:
      return launch_typed<__half>(q, k_pages, v_pages, kscale, vscale,
                                  block_table, seq_lens, out, B, kvh, G, hd,
                                  bs, max_blocks, scale, s);
    case 2:
      return launch_typed<__nv_bfloat16>(q, k_pages, v_pages, kscale, vscale,
                                         block_table, seq_lens, out, B, kvh,
                                         G, hd, bs, max_blocks, scale, s);
    default:
      return -1;
  }
}
