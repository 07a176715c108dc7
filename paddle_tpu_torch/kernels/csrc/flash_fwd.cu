// FlashAttention-2 forward for Hopper (sm_90a).
//
// Replaces the TPU forward kernels of paddle_tpu/kernels/flash_attention.py,
// launched by `_flash_fwd_impl`: `_fwd_kernel`, `_fwd_kernel_grouped`,
// `_fwd_kernel_stream_grouped` and `_fwd_kernel_stream`. Those four are
// one function laid out four ways for the TPU's VMEM (whole-sequence K/V
// blocks or double-buffered streaming, the query-head group folded into
// the rows or not); on this card one kernel covers them.
//
//   q    [B, S, H, D]    bf16 | fp16 | fp32
//   k, v [B, S, Hkv, D]  same type; H % Hkv == 0, G = H / Hkv
//   out  [B, S, H, D]    q's type: softmax(q.k^T * D^-1/2 [causal]) . v
//   lse  [B * H, S]      fp32 log-sum-exp of each row's scaled scores
//
// The arithmetic is the TPU kernel's: scores in fp32 multiplied by
// D^-1/2, masked keys set to the finite -1e30, an online softmax with m, l
// and the accumulator in fp32, P rounded to v's type before P.V, and at
// the end out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)).
//
// What bounds it: operations. Per (b, h) it does 4 S^2 D flops (half
// with the causal mask) on 2 S D (H + 2 Hkv) / H elements moved, far
// above the card's ~295 flops per byte of bf16.
//
// What the design does about it: each block keeps a 64-row query tile in
// shared memory and streams the 64-key tiles of its kv head (h / G, so
// grouped K/V are never repeated) through one shared buffer, K for the
// scores and then V for P.V. Every element of Q, K and V staged once per
// tile is reused 64 times from shared memory; each thread computes a
// 4 x 8 tile of scores and a 4 x D/8 tile of the output in registers,
// with fp32 FMAs on the CUDA cores (no tensor cores yet: this is the
// simple, right kernel; wgmma, TMA and warp specialisation are later
// work). Strides of D + 1 and 64 + 1 floats keep the shared-memory reads
// free of bank conflicts. With the causal mask no key tile past the
// diagonal is read. Rows and keys past a ragged S are zero-filled and
// masked, so any S >= 1 is taken.
//
// Layout of the work: grid (ceil(S / 64), B * H), 128 threads; thread t
// owns query rows ty + 16 i (ty = t / 8, i < 4), key columns tx + 8 j
// (tx = t % 8, j < 8) of the score tile and output columns tx + 8 j
// (j < D / 8). The 8 threads of a row group are neighbouring lanes, so
// row max and row sum take three shuffles.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBQ = 64;
constexpr int kBK = 64;

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int S, int H, int Hkv,
                     int causal, float scale) {
  constexpr int LDD = D + 1;
  constexpr int LDP = kBK + 1;
  constexpr int RI = 4;        // query rows per thread
  constexpr int CJ = 8;        // key columns per thread
  constexpr int DJ = D / 8;    // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                  // [kBQ][LDD]
  float* KVs = Qs + kBQ * LDD;       // [kBK][LDD]: K, then V
  float* Ps = KVs + kBK * LDD;       // [kBQ][LDP]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;

  load_tile<T, kBQ, D>(Qs, LDD, q, b, h, H, S, q0);

  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  int n_kt = (S + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ - 1) / kBK + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's P.V is done with KVs and Ps
    load_tile<T, kBK, D>(KVs, LDD, k, b, hk, Hkv, S, k0);
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
      const int qi = q0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kj = k0 + tx + 8 * j;
        float x = s[i][j] * scale;
        if (kj >= S || (causal && kj > qi)) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[r * LDP + tx + 8 * j] = round_to<T>(p);
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
    load_tile<T, kBK, D>(KVs, LDD, v, b, hk, Hkv, S, k0);
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
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float ls = fmaxf(l[i], 1e-30f);
    T* o = out + row_offset(b, qi, h, H, S, D);
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[tx + 8 * j] = from_f<T>(acc[i][j] / ls);
    if (tx == 0) lse[int64_t(bh) * S + qi] = m[i] + logf(ls);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int S, int H, int Hkv, int causal,
           float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<D>();
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((S + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, S, H, Hkv,
      causal, scale);
  return int(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 float* lse, int B, int S, int H, int Hkv, int D,
                 int causal, float scale, cudaStream_t stream) {
  FLASH_DISPATCH_D(D, launch, T, q, k, v, out, lse, B, S, H, Hkv, causal,
                   scale, stream)
}

}  // namespace

// Returns 0 on success, -1 for arguments the kernel does not take, else
// the cudaError_t of the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, float* lse, int B, int S, int H,
                         int Hkv, int D, int dtype, int causal, float scale,
                         void* stream) {
  if (B < 0 || S < 0 || H < 1 || Hkv < 1 || H % Hkv != 0 ||
      int64_t(B) * H > 65535)
    return -1;
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH_T(dtype, launch_typed, q, k, v, out, lse, B, S, H, Hkv, D,
                   causal, scale, s)
}
